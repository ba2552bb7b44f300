"""Continuous-batching scheduler over the engine (paged or dense).

Counterpart of ``ollama_operator_tpu/runtime/scheduler.py`` (which cannot
be reused: it imports the JAX engine). One background thread admits
waiting requests into free slots (one prefill each), runs one decode
dispatch for every running slot, and fans the tokens out to per-request
queues, one queue item per dispatch. On a paged engine, when the page
pool cannot cover the next chunk, the newest slots are preempted: their
request goes back to the front of the queue with its prompt plus the
tokens generated so far, and re-admission continues the same stream. A
dense engine never runs dry (``prepare_decode`` returns no victims and
``PagesExhausted`` cannot occur), so there admission waits for a free
slot only.

Left for later slices: radix/prefix reuse and chunked prefill, speculative
decoding, grammars, tenants and admission policy, deadlines, drain and the
supervised restart.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
import traceback
from typing import Iterator, List, Optional, Sequence

import numpy as np

from .engine import Engine, SlotOptions
from .paged import PagesExhausted


class SchedulerBusy(RuntimeError):
    """The waiting queue is full."""


class SchedulerBroken(RuntimeError):
    """The scheduler loop died; no request will be served."""


@dataclasses.dataclass
class RequestStats:
    n_prompt: int = 0
    n_generated: int = 0
    t_submit: float = 0.0
    t_first_token: float = 0.0

    @property
    def ttft_s(self) -> float:
        return max(self.t_first_token - self.t_submit, 0.0)


class Request:
    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt_ids: Sequence[int], opts: SlotOptions,
                 max_tokens: int, eog_ids: frozenset):
        with Request._ids_lock:
            self.id = next(Request._ids)
        self.prompt_ids = np.asarray(prompt_ids, np.int64)
        self.opts = opts
        self.max_tokens = max_tokens
        self.eog_ids = eog_ids
        self.out: queue.Queue = queue.Queue()
        self.cancelled = threading.Event()
        self.stats = RequestStats(n_prompt=len(self.prompt_ids),
                                  t_submit=time.monotonic())
        self.done_reason: Optional[str] = None
        # every sampled token (EOG included): a preempted request
        # re-admits from prompt + these
        self.all_tokens: List[int] = []
        self.resume_ids: Optional[np.ndarray] = None

    @property
    def admit_ids(self) -> np.ndarray:
        return (self.resume_ids if self.resume_ids is not None
                else self.prompt_ids)

    def cancel(self):
        self.cancelled.set()

    def tokens(self) -> Iterator[int]:
        """Blocking iterator over generated token ids."""
        for chunk in self.chunks():
            yield from chunk

    def chunks(self) -> Iterator[List[int]]:
        """Blocking iterator over per-dispatch batches of token ids."""
        while True:
            kind, payload = self.out.get()
            if kind == "tokens":
                yield payload
            elif kind == "done":
                self.done_reason = payload
                return
            else:
                raise RuntimeError(payload)


class Scheduler:
    def __init__(self, engine: Engine, max_queue: int = 256):
        self.engine = engine
        self.max_queue = max_queue
        self._waiting: collections.deque = collections.deque()
        self._running: List[Optional[Request]] = [None] * engine.n_slots
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.broken: Optional[str] = None
        self.n_preempted = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="torch-scheduler")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], opts: SlotOptions,
               max_tokens: int, eog_ids: frozenset = frozenset()) -> Request:
        if self.broken is not None:
            raise SchedulerBroken(self.broken)
        n = len(prompt_ids)
        if not 0 < n < self.engine.max_seq:
            raise ValueError(f"prompt of {n} tokens: need 0 < n < "
                             f"{self.engine.max_seq}")
        if not self.engine.admissible(n):
            raise ValueError(f"prompt of {n} tokens needs more KV pages "
                             f"than the pool has")
        req = Request(prompt_ids, opts, max_tokens, eog_ids)
        with self._lock:
            if len(self._waiting) >= self.max_queue:
                raise SchedulerBusy("request queue full")
            self._waiting.append(req)
        self._wake.set()
        return req

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._running)

    @property
    def has_pending(self) -> bool:
        """True while a request waits or runs."""
        return bool(self._waiting) or self.n_active > 0

    def shutdown(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=60)
        with self._lock:
            pending = list(self._waiting)
            self._waiting.clear()
        for req in pending + [r for r in self._running if r is not None]:
            req.out.put(("error", "scheduler shut down"))

    # ------------------------------------------------------------------
    def _loop(self):
        try:
            while not self._stop:
                self._reap_cancelled()
                self._admit_waiting()
                if self.n_active:
                    self._step()
                else:
                    self._wake.wait(0.05)
                    self._wake.clear()
        except Exception as e:  # noqa: BLE001 — the loop is the boundary
            self.broken = f"scheduler loop failed: {e!r}"
            traceback.print_exc()
            with self._lock:
                pending = list(self._waiting)
                self._waiting.clear()
            for req in pending + [r for r in self._running
                                  if r is not None]:
                req.out.put(("error", self.broken))

    def _finish(self, slot: int, req: Request, reason: str):
        self.engine.release(slot)
        self._running[slot] = None
        req.out.put(("done", reason))

    def _reap_cancelled(self):
        for slot, req in enumerate(self._running):
            if req is not None and req.cancelled.is_set():
                self._finish(slot, req, "stop")
        with self._lock:
            dead = [r for r in self._waiting if r.cancelled.is_set()]
            for r in dead:
                self._waiting.remove(r)
        for r in dead:
            r.out.put(("done", "stop"))

    def _admit_waiting(self):
        while True:
            with self._lock:
                if not self._waiting:
                    return
                req = self._waiting[0]
            free = self.engine.free_slots()
            if not free:
                return
            slot = free[0]
            ids = req.admit_ids
            if not self.engine.can_admit(slot, len(ids)):
                return   # wait for a finisher to free pages
            try:
                first = self.engine.admit(slot, ids, req.opts)
            except PagesExhausted:
                return
            except Exception as e:  # noqa: BLE001 — fail this request only
                with self._lock:
                    self._waiting.popleft()
                req.out.put(("error", f"admission failed: {e}"))
                continue
            with self._lock:
                self._waiting.popleft()
            self._running[slot] = req
            self._emit(slot, req, [first])

    def _emit(self, slot: int, req: Request, toks: Sequence[int]):
        """Deliver ``toks`` (one dispatch's worth) to ``req``; finishes
        the request on EOG, on its token budget, or at the context end."""
        buf: List[int] = []
        reason = None
        for tid in toks:
            if req.stats.n_generated == 0 and req.stats.t_first_token == 0:
                req.stats.t_first_token = time.monotonic()
            req.all_tokens.append(tid)
            if tid in req.eog_ids:
                reason = "stop"
                break
            req.stats.n_generated += 1
            buf.append(tid)
            if req.stats.n_generated >= req.max_tokens:
                reason = "length"
                break
            if (req.stats.n_prompt + req.stats.n_generated
                    >= self.engine.max_seq - 1):
                reason = "length"
                break
        if buf:
            req.out.put(("tokens", buf))
        if reason is not None:
            self._finish(slot, req, reason)

    def _preempt(self, slot: int):
        req = self._running[slot]
        self.engine.release(slot)
        self._running[slot] = None
        req.resume_ids = np.concatenate(
            [req.prompt_ids, np.asarray(req.all_tokens, np.int64)])
        self.n_preempted += 1
        with self._lock:
            self._waiting.appendleft(req)

    def _step(self):
        for slot in self.engine.prepare_decode():
            self._preempt(slot)
        if not self.n_active:
            return
        snapshot = {s: r for s, r in enumerate(self._running)
                    if r is not None}
        handle = self.engine.decode_n_launch()
        toks = handle.wait()
        self.engine.retire(handle.epoch)
        for slot, req in snapshot.items():
            if self._running[slot] is req:
                self._emit(slot, req, [int(t) for t in toks[:, slot]])
