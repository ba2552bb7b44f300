"""Continuous-batching scheduler over the engine (paged or dense).

Counterpart of ``ollama_operator_tpu/runtime/scheduler.py`` (which cannot
be reused: it imports the JAX engine). One background thread runs one
step at a time: it advances one piece of a chunked prefill, admits
waiting requests into free slots, runs one decode dispatch for every
decoding slot, and fans the tokens out to per-request queues, one queue
item per dispatch.

Admission reuses cached prefixes as the reference does. On a paged engine
with the radix prefix cache (the default; ``TPU_PREFIX_CACHE=0`` turns it
off) a finished request donates ``(prompt + tokens)[:-1]``'s full pages
to the tree, and a new request stitches the longest cached prefix into
its slot; elsewhere (the dense cache, or the cache off) a finished
request parks its slot and a new one extends the parked slot that shares
the longest prefix. A reuse counts from ``TPU_MIN_PREFIX_REUSE`` tokens
(16) up; only the tail is prefilled, through ``Engine.extend``. A prompt
whose tail is longer than one piece (``TPU_PREFILL_CHUNK``, unset:
decode_chunk * 8 rounded to a bucket; 0 turns chunking off) is prefilled
a piece per scheduler step between decode dispatches (Sarathi-style),
its slot parked between pieces, so a decoding slot waits at most one
piece. A stitched admission that runs the pool dry falls back to a cold
one once; a dry pool evicts radix leaves (or parked prefixes) before the
request is requeued.

On a paged engine, when the page pool cannot cover the next chunk, cached
prefixes are evicted first, then the newest slots are preempted: their
request goes back to the front of the queue with its prompt plus the
tokens generated so far, and re-admission continues the same stream. A
dense engine never runs dry (``prepare_decode`` returns no victims and
``PagesExhausted`` cannot occur).

A request with a grammar constraint (``ops/constrain.py``,
``ops/schema.py``) admits under its current mask, and every token it
receives is checked against the constraint before it is delivered: an
illegal token finishes the request with "stop". A JSON constraint whose
state lies in the device grammar table (built on this thread on the first
such request, ``_grammar_table``) decodes whole chunks, its state
advancing on the device; the host follows it through the table and, where
the device walk escaped, takes back the steps the slot did not use
(``_grammar_ack``) and installs the exact mask again. Other constrained
requests take one token a dispatch, and a dispatch takes one step when
every decoding slot is host-masked. A preempted constrained request keeps
its constraint state and re-admits under its current mask.

Left for later slices: speculative decoding, tenants and admission
policy, deadlines, async dispatch, drain and the supervised restart.
"""

from __future__ import annotations

import collections
import dataclasses
import os
import queue
import threading
import time
import traceback
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..ops.constrain import GrammarTable
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
    # prompt tokens served from a cached prefix at the last admission
    n_reused: int = 0
    t_submit: float = 0.0
    t_first_token: float = 0.0

    @property
    def ttft_s(self) -> float:
        return max(self.t_first_token - self.t_submit, 0.0)


class Request:
    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt_ids: Sequence[int], opts: SlotOptions,
                 max_tokens: int, eog_ids: frozenset, constraint=None):
        with Request._ids_lock:
            self.id = next(Request._ids)
        self.prompt_ids = np.asarray(prompt_ids, np.int64)
        # grammar state (ops/constrain.py, ops/schema.py), or None
        self.constraint = constraint
        # the device grammar table for this request's token table: None =
        # not resolved yet, False = unavailable (device tables off, the
        # build failed, or another table owns the device), else the
        # installed GrammarTable (Scheduler._grammar_table)
        self._gtable = None
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


class _PrefillJob:
    """A request whose prompt is admitting piece by piece: ``done`` tokens
    of ``req.admit_ids`` are in the slot's cache. Between pieces the slot
    is parked (engine-inactive), so the scheduler must remember that it
    is taken."""

    __slots__ = ("req", "done")

    def __init__(self, req: Request, done: int):
        self.req = req
        self.done = done


class Scheduler:
    # a cached prefix must reach this many tokens to be reused
    # (TPU_MIN_PREFIX_REUSE): a tiny reuse still pays a whole extend
    MIN_PREFIX_REUSE = 16

    def __init__(self, engine: Engine, max_queue: int = 256,
                 prefill_chunk: Optional[int] = None):
        self.engine = engine
        self.max_queue = max_queue
        self.min_prefix_reuse = int(os.environ.get(
            "TPU_MIN_PREFIX_REUSE", "") or self.MIN_PREFIX_REUSE)
        self._use_radix = engine.radix_enabled
        # chunked prefill: unset derives from the decode chunk, rounded up
        # to a real bucket; 0 admits every prompt whole
        if prefill_chunk is None:
            pc_env = os.environ.get("TPU_PREFILL_CHUNK", "")
            prefill_chunk = (int(pc_env) if pc_env
                             else engine.ecfg.decode_chunk * 8)
        self.prefill_chunk = (
            engine.bucket_for(min(int(prefill_chunk), engine.max_seq))
            if prefill_chunk else 0)
        self._waiting: collections.deque = collections.deque()
        self._running: List[Optional[Request]] = [None] * engine.n_slots
        # slot → job for requests mid-chunked-prefill
        self._prefilling: Dict[int, _PrefillJob] = {}
        # slot → token ids still in its cache (parked-slot reuse)
        self._parked: Dict[int, List[int]] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        self.broken: Optional[str] = None
        self.n_preempted = 0
        self.n_prefill_pieces = 0
        # device-table grammar walks that left the table
        self.n_grammar_escapes = 0
        # prompt tokens served from a cached prefix / prefilled, counted
        # at every admission (a re-admission counts again)
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="torch-scheduler")
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, prompt_ids: Sequence[int], opts: SlotOptions,
               max_tokens: int, eog_ids: frozenset = frozenset(),
               constraint=None) -> Request:
        if self.broken is not None:
            raise SchedulerBroken(self.broken)
        n = len(prompt_ids)
        if not 0 < n < self.engine.max_seq:
            raise ValueError(f"prompt of {n} tokens: need 0 < n < "
                             f"{self.engine.max_seq}")
        if not self.engine.admissible(n):
            raise ValueError(f"prompt of {n} tokens needs more KV pages "
                             f"than the pool has")
        req = Request(prompt_ids, opts, max_tokens, eog_ids, constraint)
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
                self._advance_prefill()
                self._admit_waiting()
                if self._decoding():
                    self._step()
                elif not self._prefilling:
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

    def _decoding(self) -> Dict[int, Request]:
        """slot → request for every slot the next decode dispatch
        advances (slots mid-chunked-prefill are parked and excluded)."""
        return {s: r for s, r in enumerate(self._running)
                if r is not None and s not in self._prefilling}

    def _finish(self, slot: int, req: Request, reason: str,
                keep_cache: bool = True):
        """End ``req`` in ``slot``. On "stop" and "length" its cache is
        kept for reuse: with the radix cache the full-page prefix of
        everything but the last token (never fed back, so not cached) is
        donated; otherwise the slot is parked with those ids."""
        parkable = (list(req.prompt_ids) + req.all_tokens)[:-1]
        park = (keep_cache and reason in ("stop", "length")
                and len(parkable) > 0)
        if self._use_radix:
            if park:
                self.engine.donate_prefix(slot, parkable)
            else:
                self.engine.release(slot)
        else:
            self.engine.release(slot, park=park)
            if park:
                self._parked[slot] = parkable
            else:
                self._parked.pop(slot, None)
        self._running[slot] = None
        req.out.put(("done", reason))

    def _reap_cancelled(self):
        for slot, req in enumerate(self._running):
            if req is not None and req.cancelled.is_set():
                if slot in self._prefilling:
                    self._abort_prefill(slot)
                else:
                    self._finish(slot, req, "stop", keep_cache=False)
        with self._lock:
            dead = [r for r in self._waiting if r.cancelled.is_set()]
            for r in dead:
                self._waiting.remove(r)
        for r in dead:
            r.out.put(("done", "stop"))

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _best_prefix(self, req: Request):
        """(slot, reuse_len) of the parked slot sharing the longest token
        prefix with the request, or (None, 0). One tail token must remain
        to prefill, the reuse must reach the floor, and the tail's bucket
        must fit above it."""
        if self._use_radix:
            return None, 0
        ids = req.admit_ids
        best, best_m = None, 0
        for slot, parked in self._parked.items():
            k = min(len(parked), len(ids) - 1)
            m = 0
            while m < k and parked[m] == ids[m]:
                m += 1
            if m > best_m:
                best, best_m = slot, m
        if best is None or best_m < self.min_prefix_reuse:
            return None, 0
        if best_m + self.engine.bucket_for(len(ids) - best_m) \
                > self.engine.max_seq:
            return None, 0
        return best, best_m

    def _evict_one_parked(self, n_pages: int = 1) -> bool:
        """Return cached pages to the pool under pressure: up to
        ``n_pages`` least-recently-used radix leaves, or one whole parked
        prefix (the oldest). False when there was nothing to evict."""
        if self._use_radix:
            return self.engine.radix_evict(n_pages) > 0
        for slot in list(self._parked):
            if self._running[slot] is None:
                self._parked.pop(slot)
                self.engine.free_slot_pages(slot)
                return True
        return False

    def _pages_for(self, n_tokens: int) -> int:
        """Pages a prompt of ``n_tokens`` needs, plus one: the eviction
        size after a dry admission."""
        ps = self.engine.ecfg.page_size or 1
        return -(-n_tokens // ps) + 1

    def _stitch_admission(self, slot: int, req: Request) -> int:
        """Probe the radix tree, apply the reuse floor and the tail
        bucket's fit (trimming page by page), then stitch the prefix into
        ``slot``. A dry pool at the copy-on-write page evicts and falls
        back to a cold admission (the stitch left the slot clean)."""
        ids = req.admit_ids
        want = self.engine.prefix_probe(ids)
        ps = self.engine.ecfg.page_size
        while (want >= self.min_prefix_reuse
               and want + self.engine.bucket_for(len(ids) - want)
               > self.engine.max_seq):
            want = (want - 1) // ps * ps
        if want < self.min_prefix_reuse:
            return 0
        try:
            return self.engine.stitch(slot, ids, want)
        except PagesExhausted:
            self._evict_one_parked()
            return 0

    def _pick_slot(self, free: List[int], n_tokens: int) -> int:
        """A free slot for a cold admission: one with no parked prefix
        and room for the prompt first, so reusable caches stay as long as
        slots allow."""
        for cond in (lambda s: s not in self._parked
                     and self.engine.can_admit(s, n_tokens),
                     lambda s: self.engine.can_admit(s, n_tokens),
                     lambda s: s not in self._parked):
            for s in free:
                if cond(s):
                    return s
        return free[0]

    def _admit_waiting(self):
        while True:
            # slots mid-chunked-prefill are engine-inactive but taken
            free = [s for s in self.engine.free_slots()
                    if s not in self._prefilling]
            if not free:
                return
            with self._lock:
                if not self._waiting:
                    return
                req = self._waiting.popleft()
            ids = req.admit_ids
            slot, reuse_len = self._best_prefix(req)
            if slot is None:
                slot = self._pick_slot(free, len(ids))
            # the slot's parked cache is spoken for either way
            self._parked.pop(slot, None)
            if self._use_radix:
                reuse_len = self._stitch_admission(slot, req)
            piece = self.prefill_chunk
            if (piece and len(ids) - reuse_len > piece
                    and len(ids) + piece <= self.engine.max_seq):
                if not self._start_chunked(slot, req, reuse_len):
                    return
            elif not self._admit_one(slot, req, reuse_len):
                return

    def _requeue_dry(self, req: Request, err: Exception) -> bool:
        """A dry pool at admission: evict cached pages and requeue the
        request at the front (False), or fail it when no pool could ever
        hold it (True)."""
        if not self.engine.admissible(len(req.admit_ids)):
            req.out.put(("error", f"prompt needs more KV pages than the "
                                  f"pool has: {err}"))
            return True
        self._evict_one_parked(self._pages_for(len(req.admit_ids)))
        with self._lock:
            self._waiting.appendleft(req)
        return False

    def _admit_one(self, slot: int, req: Request, reuse_len: int) -> bool:
        """One whole admission, cold or prefix-reusing. False when the
        pool ran dry and the request was requeued: stop admitting for
        this pass."""
        ids = req.admit_ids
        try:
            mask_row = (req.constraint.mask_row()
                        if req.constraint is not None else None)
            try:
                first = (self.engine.extend(slot, ids, reuse_len, req.opts,
                                            mask_row=mask_row)
                         if reuse_len else
                         self.engine.admit(slot, ids, req.opts,
                                           mask_row=mask_row))
            except PagesExhausted:
                if not (reuse_len and self._use_radix):
                    raise
                # the stitched tail ran dry (extend released the shared
                # mappings): fall back to a cold admission once
                reuse_len = 0
                first = self.engine.admit(slot, ids, req.opts,
                                          mask_row=mask_row)
            req.stats.n_reused = reuse_len
        except PagesExhausted as e:
            return self._requeue_dry(req, e)
        except Exception as e:  # noqa: BLE001 — fail this request only
            req.out.put(("error", f"admission failed: {e}"))
            return True
        self._post_admit(slot, req, first)
        return True

    def _post_admit(self, slot: int, req: Request, first: int):
        """Shared tail of a whole admission and of a chunked one's last
        piece: the slot is taken, the reuse counted, and the first token
        delivered (for a constrained request: checked, then its mask
        installed)."""
        self._running[slot] = req
        n_re = min(req.stats.n_reused, len(req.admit_ids))
        self.prefix_hit_tokens += n_re
        self.prefix_miss_tokens += len(req.admit_ids) - n_re
        self._emit(slot, req, [first])

    def _start_chunked(self, slot: int, req: Request,
                       reuse_len: int) -> bool:
        """First piece of a chunked admission: prefill one piece, park
        the slot and register the job; the other pieces interleave with
        decode dispatches (:meth:`_advance_prefill`). A piece samples
        with the default options, as the reference's does, and its token
        is dropped. False when the pool ran dry and the request was
        requeued."""
        ids = req.admit_ids
        end = reuse_len + self.prefill_chunk
        try:
            try:
                if reuse_len:
                    self.engine.extend(slot, ids[:end], reuse_len)
                else:
                    self.engine.admit(slot, ids[:end])
            except PagesExhausted:
                if not (reuse_len and self._use_radix):
                    raise
                reuse_len, end = 0, self.prefill_chunk
                self.engine.admit(slot, ids[:end])
            req.stats.n_reused = reuse_len
            self.engine.release(slot, park=True)
        except PagesExhausted as e:
            return self._requeue_dry(req, e)
        except Exception as e:  # noqa: BLE001 — fail this request only
            req.out.put(("error", f"admission failed: {e}"))
            return True
        self.n_prefill_pieces += 1
        self._running[slot] = req
        self._prefilling[slot] = _PrefillJob(req, end)
        return True

    def _abort_prefill(self, slot: int):
        """A request cancelled mid-chunked-prefill: its slot's pages go
        back to the pool."""
        job = self._prefilling.pop(slot)
        self._running[slot] = None
        self.engine.release(slot)
        job.req.out.put(("done", "stop"))

    def _advance_prefill(self):
        """One piece for the oldest chunked admission, at most one a
        scheduler step. The last piece samples the first token with the
        request's options (seeded from the slot and the full prompt
        length, as a whole admission's)."""
        if not self._prefilling:
            return
        slot = next(iter(self._prefilling))
        job = self._prefilling[slot]
        req = job.req
        if req.cancelled.is_set():
            self._abort_prefill(slot)
            return
        ids = req.admit_ids
        end = min(job.done + self.prefill_chunk, len(ids))
        final = end == len(ids)
        try:
            if final:
                mask_row = (req.constraint.mask_row()
                            if req.constraint is not None else None)
                first = self.engine.extend(slot, ids, job.done, req.opts,
                                           mask_row=mask_row)
            else:
                self.engine.extend(slot, ids[:end], job.done)
                self.engine.release(slot, park=True)
                job.done = end
        except PagesExhausted:
            # back out and requeue: the re-admission restarts the prompt
            # (no token was emitted yet)
            del self._prefilling[slot]
            self._running[slot] = None
            self.engine.release(slot)
            self._evict_one_parked(self._pages_for(len(ids)))
            with self._lock:
                self._waiting.appendleft(req)
            return
        self.n_prefill_pieces += 1
        if final:
            del self._prefilling[slot]
            self._post_admit(slot, req, first)

    # ------------------------------------------------------------------
    # decode
    # ------------------------------------------------------------------
    def _emit(self, slot: int, req: Request, toks: Sequence[int]) -> bool:
        """Deliver ``toks`` (one dispatch's worth, or the admission's
        first token) to ``req``; finishes the request on EOG, on its token
        budget, or at the context end. Returns True while it goes on.

        A constrained request's tokens are checked against its constraint
        before they are delivered, as the JAX scheduler's ``_fanout``
        does, and an illegal one finishes it with "stop". A host-masked
        slot was frozen after the dispatch's first step, so only its first
        token counts, and its mask is refreshed after it. A device-table
        slot's tokens count while the host's walk through the table stays
        inside it: at the token where the walk leaves the table (the slot
        froze on the device after it) the rest is dropped, the host
        lengths the slot did not use are taken back, and the exact mask
        is installed again (back in device-table mode when the state is
        in the table)."""
        c = req.constraint
        walk = None          # [table, state id] of a device-table slot
        if c is not None and self.engine._gdev_mode[slot]:
            gt = self._grammar_table(req)
            if gt is not None:
                st = gt.state_id(c.state)
                if st < 0:
                    # the host's and the device's walks disagree: drop
                    # the dispatch and start again from the exact state
                    self._grammar_ack(slot, len(toks))
                    self._refresh_mask(slot, req)
                    return True
                walk = [gt, st]
        buf: List[int] = []
        reason = None
        for r, tid in enumerate(toks):
            rest = len(toks) - (r + 1)
            if c is not None:
                if walk is None and r >= 1:
                    break
                if tid not in req.eog_ids and not c.advance(tid):
                    if walk is not None:
                        self._grammar_ack(slot, rest)
                    reason = "stop"
                    break
            if req.stats.n_generated == 0 and req.stats.t_first_token == 0:
                req.stats.t_first_token = time.monotonic()
            req.all_tokens.append(tid)
            if tid in req.eog_ids:
                if walk is not None:
                    # an EOG token escapes on the device: the slot froze
                    # after it
                    self._grammar_ack(slot, rest)
                reason = "stop"
                break
            req.stats.n_generated += 1
            buf.append(tid)
            if (req.stats.n_generated >= req.max_tokens
                    or req.stats.n_prompt + req.stats.n_generated
                    >= self.engine.max_seq - 1):
                reason = "length"
                break
            if c is None:
                continue
            if walk is None:
                self._refresh_mask(slot, req)
                continue
            gt = walk[0]
            nid = (int(gt.trans[walk[1], tid]) if tid < gt.trans.shape[1]
                   else -1)
            if nid >= 0:
                walk[1] = nid        # still in the table
                continue
            # the device walk escaped after this token: the rest of the
            # dispatch ran with the slot frozen
            self.n_grammar_escapes += 1
            self._grammar_ack(slot, rest)
            self._refresh_mask(slot, req)
            break
        if buf:
            req.out.put(("tokens", buf))
        if reason is not None:
            self._finish(slot, req, reason)
            return False
        return True

    # -- the device grammar table ----------------------------------------
    def _grammar_table(self, req: Request) -> Optional[GrammarTable]:
        """The engine-installed GrammarTable for ``req``'s constraint, or
        None where device tables are unavailable for it (the engine's
        knob is off, the constraint is not the generic JSON one, the
        build failed, or another table owns the device while slots run
        on it). Resolved once a request; ``GrammarTable.for_table``
        caches the build on the token table, so later requests share
        it."""
        c = req.constraint
        if (c is None or not getattr(c, "grammar_table_ok", False)
                or not self.engine._grammar_device):
            return None
        if req._gtable is not None:
            return req._gtable or None
        try:
            gt = GrammarTable.for_table(c.table,
                                        cap=self.engine._gstates_cap)
        except Exception:  # noqa: BLE001 — any build failure: host masks
            gt = None
        if gt is None or not self.engine.install_grammar(
                ("grammar", id(gt)), gt.mask, gt.trans):
            req._gtable = False
            return None
        req._gtable = gt
        return gt

    def _refresh_mask(self, slot: int, req: Request):
        """Install ``req``'s current mask on ``slot``; where its state is
        in the installed device table the slot enters device-table mode
        and keeps the whole decode chunk."""
        gid = -1
        gt = self._grammar_table(req)
        if gt is not None:
            gid = gt.state_id(req.constraint.state)
        self.engine.set_mask(slot, req.constraint.mask_row(), gid=gid)

    def _grammar_ack(self, slot: int, over: int):
        """Take back the host lengths a device-table slot was advanced by
        at launch but did not use (the frozen steps after an escape)."""
        if over <= 0:
            return
        rb = np.zeros((self.engine.n_slots,), np.int64)
        rb[slot] = over
        self.engine.spec_ack(rb)

    def _preempt(self, slot: int):
        req = self._running[slot]
        self.engine.release(slot)
        self._running[slot] = None
        req.resume_ids = np.concatenate(
            [req.prompt_ids, np.asarray(req.all_tokens, np.int64)])
        self.n_preempted += 1
        with self._lock:
            self._waiting.appendleft(req)

    def _relieve_pressure(self):
        """Make sure every decoding slot has pages for the next chunk:
        evict cached prefixes first, then preempt the newest slot, one at
        a time."""
        while True:
            victims = self.engine.prepare_decode()
            if not victims:
                return
            if not self._evict_one_parked():
                self._preempt(victims[0])

    def _step(self):
        self._relieve_pressure()
        snapshot = self._decoding()
        if not snapshot:
            return
        # host-masked grammar slots take one token a dispatch (the engine
        # freezes them after the first step); when every decoding slot is
        # host-masked, a one-step dispatch does the same work for less
        gdev = self.engine._gdev_mode
        n = (1 if all(r.constraint is not None and not gdev[s]
                      for s, r in snapshot.items()) else None)
        handle = self.engine.decode_n_launch(n)
        toks = handle.wait()
        self.engine.retire(handle.epoch)
        for slot, req in snapshot.items():
            if self._running[slot] is req:
                self._emit(slot, req, [int(t) for t in toks[:, slot]])
