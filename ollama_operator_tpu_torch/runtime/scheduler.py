"""Continuous-batching scheduler over the engine (paged or dense).

Counterpart of ``ollama_operator_tpu/runtime/scheduler.py`` (which cannot
be reused: it imports the JAX engine). One background thread runs one
step at a time: it sheds what can no longer be served, advances one piece
of a chunked prefill, admits waiting requests into free slots, runs one
decode dispatch for every decoding slot, and fans the tokens out to
per-request queues, one queue item per dispatch. An embedding model (a
BERT encoder) has no scheduler: it carries the quiet facade
``runtime/service._IdleScheduler``, and a decoder's embeddings run on the
caller's thread beside this loop (``LoadedModel.embed``).

The waiting line is the reference's admission policy
(``runtime/admission.py``): strict priority classes (``high``, ``normal``,
``best_effort``) with per-tenant weighted deficit round robin inside a
class, a bounded queue where an arrival displaces a strictly lower
class's newest request, a per-tenant queued cap (429), early rejection of
a request the queue model predicts will miss its TTFT SLO, per-tenant
decode-token rate limits (an over-rate best-effort stream is throttled:
preempted and resumed later on the same stream), and priority preemption
(a queued higher-class request evicts the lowest-class running one when
every slot is busy, ``TPU_PRIORITY_PREEMPT``). A request's
``deadline`` sheds it with 503 + Retry-After while it waits, and ends it
with finish reason ``timeout`` once it has streamed tokens.

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
prefixes are evicted first, then running requests are preempted (lowest
class first, newest admission within a class): their request goes back
to the line ahead of queued requests of its class with its prompt plus
the tokens generated so far, and re-admission continues the same stream.
A dense engine never runs dry.

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
every decoding slot is host-masked.

Lifecycle (the reference's crash-only serving): each dispatch wait runs
under a hung-dispatch watchdog (``TPU_DISPATCH_WATCHDOG_MS``, else 100x
the mean dispatch, clamped to 15..120 s). A failed step (an exception, or
a watchdog fire) is followed by a supervised restart: every slot is
released, the radix tree reset, and the greedy and seeded streams replay
(prompt + generated re-prefilled through the preempt/resume path; a
seeded draw is keyed on (seed, position), so the continuation is the
same wherever the re-prefill's logits equal the decode's: in f32 on the
CPU; in bf16 on the card a near-tie greedy token, and a sampled one much
more often, can go the other way); other streams get exactly one error
frame. After
``TPU_ENGINE_MAX_RESTARTS`` consecutive failures the scheduler is broken
for good (the pod's liveness probe then fails). ``begin_drain`` sheds new
work with 503 + Retry-After while running streams finish; ``drain`` waits
up to ``TPU_DRAIN_TIMEOUT_S`` and ends stragglers with a ``drain`` frame.

A multimodal request (``embeds``: a prompt whose image positions carry a
pad id and whose embedding sequence was spliced from the vision tower's
output) admits whole, through ``Engine.admit(embeds=...)``: the padded
ids of two different images are equal, so it never reuses a cached
prefix, never donates or parks its own, and is never chunked; it cannot
re-prefill from token ids, so it is preempted only when no other request
can make room (and then ends with an error), is never a priority victim
or throttled, and a restart fails it ("multimodal") instead of replaying
it. A mirostat stream's budget restarts at 2·tau on any re-admission, so
a restart does not replay it either ("nondeterministic").

Left for later slices: speculative decoding and async dispatch (the
reference launches dispatch N+1 before fanning out dispatch N; here the
whole host enqueue of a dispatch is the step, so nothing would overlap).
"""

from __future__ import annotations

import dataclasses
import os
import queue
import sys
import threading
import time
import traceback
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from ..ops.constrain import GrammarTable
from ..server.metrics import GLOBAL as METRICS
from . import accounting
from .admission import (DEFAULT_TENANT, PRIORITY_RANK, AdmissionQueue,
                        TenantRateLimited, TenantRateLimiter,
                        observed_throughput_tps, predict_queue_wait_s,
                        retry_after_s, shed_labels)
from .engine import Engine, SlotOptions
from .errors import DeadlineExceeded
from .faults import FAULTS, InjectedFault
from .paged import PagesExhausted
from .trace import FLIGHT, TRACER

class SchedulerBusy(RuntimeError):
    """submit() refused the request for now (queue full, draining);
    ``retry_after_s`` rides into the HTTP 503's Retry-After header."""

    def __init__(self, msg: str, *, retry_after_s: int = 1):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


class SchedulerOverloaded(SchedulerBusy):
    """submit() predicts from the queue model that the request would miss
    its TTFT SLO: rejected up front (503 + computed Retry-After)."""


class SchedulerBroken(RuntimeError):
    """The scheduler loop failed past its restart budget; no request will
    be served."""


class WatchdogTimeout(RuntimeError):
    """A dispatch wait exceeded the hung-dispatch watchdog's budget.
    Treated exactly like an engine failure: supervised restart, then
    replay."""


# lifecycle knobs are read at every call, so a running scheduler honors a
# new value at its next restart or drain

def replay_max_streams() -> int:
    """TPU_RESTART_REPLAY_MAX: streams replayed a restart (0: replay off,
    every in-flight stream errors exactly once)."""
    return int(os.environ.get("TPU_RESTART_REPLAY_MAX", "64") or "0")


def replay_token_budget() -> int:
    """TPU_RESTART_REPLAY_TOKENS: prompt + generated tokens the replays of
    one restart may re-prefill in all."""
    return int(os.environ.get("TPU_RESTART_REPLAY_TOKENS", "65536")
               or "0")


def drain_timeout_s() -> float:
    """TPU_DRAIN_TIMEOUT_S: how long drain() lets running streams finish
    before it ends the stragglers."""
    return float(os.environ.get("TPU_DRAIN_TIMEOUT_S", "30") or "0")


@dataclasses.dataclass
class RequestStats:
    n_prompt: int = 0
    n_generated: int = 0
    # prompt tokens served from a cached prefix at the last admission
    n_reused: int = 0
    t_submit: float = 0.0
    t_admitted: float = 0.0
    t_first_token: float = 0.0
    t_done: float = 0.0

    @property
    def ttft_s(self) -> float:
        return max(self.t_first_token - self.t_submit, 0.0)

    @property
    def decode_tok_s(self) -> float:
        dur = self.t_done - self.t_first_token
        if dur <= 0 or self.n_generated <= 1:
            return 0.0
        return (self.n_generated - 1) / dur


class Request:
    _ids = iter(range(1, 1 << 62))
    _ids_lock = threading.Lock()

    def __init__(self, prompt_ids: Sequence[int], opts: SlotOptions,
                 max_tokens: int, eog_ids: frozenset, constraint=None,
                 deadline: Optional[float] = None,
                 priority: str = "normal", tenant: str = DEFAULT_TENANT,
                 embeds=None):
        with Request._ids_lock:
            self.id = next(Request._ids)
        # admission policy: class, fairness tenant, and the WDRR token
        # cost (prompt + predicted decode tokens, refined by submit())
        self.priority = priority
        self.rank = PRIORITY_RANK.get(priority, 1)
        self.tenant = tenant
        self.cost = float(len(prompt_ids) + max_tokens)
        # a throttled request is not admitted again before this stamp
        self.resume_at = 0.0
        self.prompt_ids = np.asarray(prompt_ids, np.int64)
        # [n_prompt, D] multimodal prompt embeddings, or None
        self.embeds = embeds
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
        # span timeline (runtime/trace.py); the shared no-op trace when
        # TPU_TRACE=0
        self.trace = TRACER.begin(self.id)
        # when the last token chunk was delivered (inter-token latency)
        self._t_last_emit = 0.0
        self.slot: Optional[int] = None
        self.error: Optional[str] = None
        # absolute time.monotonic() budget, or None: expired while queued
        # → shed (503), expired mid-generation → finish reason "timeout"
        self.deadline = deadline
        self.done_reason: Optional[str] = None
        # every sampled token (EOG included): a preempted or replayed
        # request re-admits from prompt + these
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
        """Blocking iterator over per-dispatch batches of token ids. A
        request shed before it held a slot raises
        :class:`DeadlineExceeded` (``while_queued``); an engine failure it
        could not survive raises RuntimeError."""
        while True:
            kind, payload = self.out.get()
            if kind == "tokens":
                yield payload
            elif kind == "done":
                self.done_reason = payload
                return
            elif kind == "shed":
                msg, retry = payload
                raise DeadlineExceeded(msg, while_queued=True,
                                       retry_after_s=retry)
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
    # ceiling on the supervised-restart backoff (it doubles per
    # consecutive failure from restart_backoff)
    RESTART_BACKOFF_CAP = 2.0

    def __init__(self, engine: Engine, max_queue: int = 256,
                 prefill_chunk: Optional[int] = None,
                 max_restarts: Optional[int] = None,
                 restart_backoff: Optional[float] = None):
        self.engine = engine
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
        # supervised restarts: a failed step rebuilds the engine's slot
        # state up to max_restarts consecutive times before the scheduler
        # is broken for good
        self.max_restarts = (
            max_restarts if max_restarts is not None
            else int(os.environ.get("TPU_ENGINE_MAX_RESTARTS", "3")))
        self.restart_backoff = (
            restart_backoff if restart_backoff is not None
            else float(os.environ.get("TPU_ENGINE_RESTART_BACKOFF_S",
                                      "0.05")))
        self.n_restarts = 0
        self._consecutive_failures = 0
        # the waiting line (runtime/admission.py)
        self._admission = AdmissionQueue(max_queue=max_queue)
        self._limiter = TenantRateLimiter.from_env()
        self._priority_preempt = os.environ.get(
            "TPU_PRIORITY_PREEMPT", "1").lower() not in ("0", "false")
        # EWMA of generated tokens a finished request: the predicted
        # decode half of a request's WDRR cost
        self._avg_decode = 64.0
        # preempted requests re-admit ahead of queued ones of their class;
        # throttled ones wait for their tenant's bucket; recovering ones
        # replay after a restart
        self._preempted: List[Request] = []
        self._throttled: List[Request] = []
        self._recovering: List[Request] = []
        self.n_preempted = 0
        self.n_throttles = 0
        self.n_replays = 0
        self.n_replay_fallbacks = 0
        self.draining = False
        # hung-dispatch watchdog: a helper thread runs each dispatch wait
        # so this thread can bound it; a fired worker is abandoned
        self._wd_thread: Optional[threading.Thread] = None
        self._wd_req: Optional[queue.Queue] = None
        self._wd_resp: Optional[queue.Queue] = None
        self.n_watchdog_fires = 0
        self._running: List[Optional[Request]] = [None] * engine.n_slots
        # slot → job for requests mid-chunked-prefill
        self._prefilling: Dict[int, _PrefillJob] = {}
        # slot → token ids still in its cache (parked-slot reuse)
        self._parked: Dict[int, List[int]] = {}
        self._lock = threading.Lock()
        self._wake = threading.Event()
        self._stop = False
        # None while serving, else why the loop stopped for good
        self.broken: Optional[str] = None
        self.n_prefill_pieces = 0
        # device-table grammar walks that left the table
        self.n_grammar_escapes = 0
        # prompt tokens served from a cached prefix / prefilled, counted
        # at every admission (a re-admission counts again)
        self.prefix_hit_tokens = 0
        self.prefix_miss_tokens = 0
        self.total_generated = 0
        self.total_prompt = 0
        self.acct = accounting.make_accounting(engine.cfg, engine.device)
        # ring of recent finished requests' stats
        self.finished: List[RequestStats] = []
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="torch-scheduler")
        self._thread.start()

    # ------------------------------------------------------------------
    def _tokens_done(self) -> float:
        """Tokens through the engine so far (the queue model's
        numerator)."""
        return float(self.total_prompt + self.total_generated)

    def submit(self, prompt_ids: Sequence[int], opts: SlotOptions,
               max_tokens: int, eog_ids: frozenset = frozenset(),
               constraint=None, deadline_s: Optional[float] = None,
               priority: str = "normal", tenant: str = DEFAULT_TENANT,
               ttft_slo_s: Optional[float] = None, embeds=None) -> Request:
        n = len(prompt_ids)
        if not 0 < n < self.engine.max_seq:
            raise ValueError(f"prompt of {n} tokens: need 0 < n < "
                             f"{self.engine.max_seq}")
        if not self.engine.admissible(n):
            raise ValueError(f"prompt of {n} tokens needs more KV pages "
                             f"than the pool has")
        deadline = (time.monotonic() + deadline_s
                    if deadline_s is not None and deadline_s > 0 else None)
        req = Request(prompt_ids, opts, max_tokens, eog_ids, constraint,
                      deadline=deadline, priority=priority, tenant=tenant,
                      embeds=embeds)
        req.cost = float(n + min(max_tokens, max(16, int(self._avg_decode))))
        victim = None
        # the broken check and the enqueue under the lock the failure path
        # drains under: no request slips in after the final drain
        with self._lock:
            if self.broken is not None:
                raise SchedulerBroken(self.broken)
            if self.draining:
                retry = min(120, max(1, int(drain_timeout_s())))
                METRICS.inc("tpu_model_requests_shed_total")
                METRICS.inc("tpu_model_drain_shed_total")
                FLIGHT.record("shed", rid=req.id, cause="draining",
                              cls=priority, tenant=tenant,
                              retry_after_s=retry)
                raise SchedulerBusy("server draining", retry_after_s=retry)
            cap = int(os.environ.get("TPU_TENANT_MAX_QUEUED", "0") or 0)
            if cap > 0 and self._admission.queued_for(tenant) >= cap:
                METRICS.inc("tpu_model_requests_shed_total")
                METRICS.inc("tpu_model_shed_total",
                            labels=shed_labels(priority, "tenant_cap"))
                FLIGHT.record("shed", rid=req.id, cause="tenant_cap",
                              cls=priority, tenant=tenant, cap=cap)
                raise TenantRateLimited(
                    f"tenant {tenant!r} already has {cap} requests "
                    f"queued", retry_after_s=min(30, max(1, cap)))
            if ttft_slo_s is not None:
                # token backlog at equal or higher priority over the
                # observed throughput: a request predicted to miss its
                # TTFT SLO is refused now, with a computed Retry-After
                backlog = self._admission.backlog_tokens(req.rank)
                try:
                    predicted = predict_queue_wait_s(backlog,
                                                     self._tokens_done())
                except Exception as e:  # noqa: BLE001 — fails open
                    FLIGHT.record("admission_predict_failed",
                                  rid=req.id, error=str(e)[:120])
                    predicted = 0.0
                if predicted > ttft_slo_s:
                    tps = observed_throughput_tps(self._tokens_done())
                    retry = retry_after_s(predicted, ttft_slo_s, tps)
                    METRICS.inc("tpu_model_requests_shed_total")
                    METRICS.inc("tpu_model_shed_total",
                                labels=shed_labels(priority, "slo_predict"))
                    FLIGHT.record(
                        "early_reject", rid=req.id, cls=priority,
                        tenant=tenant, predicted_ms=int(predicted * 1e3),
                        slo_ms=int(ttft_slo_s * 1e3), retry_after_s=retry)
                    raise SchedulerOverloaded(
                        f"predicted queue wait {predicted:.2f}s exceeds "
                        f"ttft_slo {ttft_slo_s:.2f}s", retry_after_s=retry)
            accepted, victim = self._admission.offer(req)
            if not accepted:
                retry = self._retry_after_estimate(req.rank)
                self._observe_wait(req)
                METRICS.inc("tpu_model_requests_shed_total")
                METRICS.inc("tpu_model_shed_total",
                            labels=shed_labels(priority, "queue_full"))
                FLIGHT.record("shed", rid=req.id, cause="queue_full",
                              cls=priority, tenant=tenant,
                              qsize=self._admission.max_queue,
                              retry_after_s=retry)
                raise SchedulerBusy(
                    f"request queue full ({self._admission.max_queue} "
                    f"waiting)", retry_after_s=retry)
        if victim is not None:
            # a strictly lower class's newest request made room
            FLIGHT.record("displaced", rid=victim.id, cls=victim.priority,
                          tenant=victim.tenant, by=req.id,
                          by_cls=req.priority)
            self._shed(victim, cause="queue_full")
        req.trace.set_identity(priority, tenant)
        req.trace.event("queued", n_prompt=n, max_tokens=max_tokens,
                        cls=priority, tenant=tenant)
        self._wake.set()
        return req

    def _retry_after_estimate(self, rank: int) -> int:
        """Retry-After for a refused request: the queue model's time to
        drain the backlog at its priority, at least 1 s (a depth
        heuristic while the model has no throughput yet)."""
        backlog = self._admission.backlog_tokens(rank)
        tps = observed_throughput_tps(self._tokens_done())
        if tps > 0:
            return int(min(max(1, round(backlog / tps + 0.5)), 120))
        return min(30, max(1, self.qsize))

    @property
    def n_active(self) -> int:
        return sum(r is not None for r in self._running)

    @property
    def qsize(self) -> int:
        """Requests waiting for a slot (queued, preempted, throttled,
        recovering)."""
        return (len(self._admission) + len(self._preempted)
                + len(self._throttled) + len(self._recovering))

    @property
    def has_pending(self) -> bool:
        """True while a request waits or runs."""
        return (self.n_active > 0 or bool(self._preempted)
                or bool(self._throttled) or bool(self._recovering)
                or not self._admission.empty())

    def _detach_all(self) -> List[Request]:
        """Take every request off the scheduler (the loop has stopped):
        the running ones, then the waiting ones."""
        running = [r for r in self._running if r is not None]
        self._running = [None] * self.engine.n_slots
        self._prefilling.clear()
        waiting = self._preempted + self._throttled + self._recovering
        self._preempted, self._throttled, self._recovering = [], [], []
        return running + waiting + self._admission.drain()

    def shutdown(self):
        """Stop the loop (bounded) and end every attached request with a
        clean "unloaded" frame, so no reader blocks after an unload."""
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)
        if self._wd_req is not None:
            self._wd_req.put(None)
            if self._wd_thread is not None:
                # joined (bounded: a helper in a wedged wait is left), so
                # no daemon thread wakes into the interpreter's exit: a
                # server's SIGTERM then ended in "terminate called without
                # an active exception" (SIGABRT) about one exit in twenty
                self._wd_thread.join(timeout=10)
            self._wd_thread = None
        for req in self._detach_all():
            req.stats.t_done = time.monotonic()
            req.out.put(("done", "unloaded"))

    def begin_drain(self):
        """Start draining: new submits shed with 503 + Retry-After,
        running streams keep generating. Idempotent."""
        with self._lock:
            if self.draining or self.broken is not None:
                return
            self.draining = True
        METRICS.inc("tpu_model_drain_started_total")
        FLIGHT.record("drain", phase="begin", running=self.n_active,
                      queued=self.qsize)

    def drain(self, timeout_s: Optional[float] = None) -> int:
        """Graceful drain: begin_drain(), wait up to ``timeout_s``
        (default TPU_DRAIN_TIMEOUT_S) for every attached stream to finish,
        then stop the loop and end the stragglers: running streams get a
        terminal ("done", "drain") frame (their partial output stands),
        waiting ones are shed with 503. Returns the stragglers."""
        self.begin_drain()
        if timeout_s is None:
            timeout_s = drain_timeout_s()
        deadline = time.monotonic() + max(0.0, timeout_s)
        while time.monotonic() < deadline and self.has_pending:
            time.sleep(0.02)
        shed = 0
        if self.has_pending:
            self._stop = True
            self._wake.set()
            self._thread.join(timeout=10)
            retry = min(120, max(1, int(timeout_s) or 1))
            running = {id(r) for r in self._running if r is not None}
            for slot, req in enumerate(self._running):
                if req is not None:
                    try:
                        self.engine.release(slot)
                    except Exception:  # noqa: BLE001 — best-effort teardown
                        pass
            for req in self._detach_all():
                req.stats.t_done = time.monotonic()
                if id(req) in running:
                    req.out.put(("done", "drain"))
                else:
                    req.out.put(("shed", ("server draining", retry)))
                shed += 1
            METRICS.inc("tpu_model_drain_shed_total", float(shed))
        FLIGHT.record("drain", phase="complete", shed=shed)
        return shed

    # -- /api/ps blocks ----------------------------------------------------
    def admission_stats(self) -> dict:
        """The admission policy now: per-class queue depth and token
        backlog, throttles, and the knobs in force."""
        out = self._admission.stats()
        out.update({
            "default_priority": os.environ.get("TPU_DEFAULT_PRIORITY",
                                               "normal") or "normal",
            "ttft_slo_ms": float(os.environ.get("TPU_TTFT_SLO_MS", "0")
                                 or 0),
            "priority_preempt": self._priority_preempt,
            "rate_limited_tenants": self._limiter.enabled,
            "throttled": len(self._throttled),
            "throttles": self.n_throttles,
            "shed_by_class": {
                p: int(sum(METRICS.get("tpu_model_shed_total",
                                       shed_labels(p, c))
                           for c in ("queue_full", "deadline",
                                     "slo_predict", "tenant_cap")))
                for p in PRIORITY_RANK},
        })
        return out

    def lifecycle_stats(self) -> dict:
        """serving/draining/broken, the live work counts the operator's
        drain-first shrink polls, the replay budget in force, and the
        watchdog's budget and fires."""
        return {
            "state": ("broken" if self.broken is not None
                      else "draining" if self.draining else "serving"),
            "active_streams": self.n_active,
            "queued": self.qsize,
            "restarts": self.n_restarts,
            "replay": {
                "enabled": replay_max_streams() > 0,
                "max_streams": replay_max_streams(),
                "token_budget": replay_token_budget(),
                "replayed_streams": self.n_replays,
                "fallbacks": self.n_replay_fallbacks,
                "recovering": len(self._recovering),
            },
            "watchdog": {
                "timeout_s": round(self._watchdog_timeout_s(), 3),
                "fires": self.n_watchdog_fires,
            },
        }

    def utilization_stats(self, window_s: float = 60.0) -> dict:
        """MFU, goodput, occupancy and the wall-clock breakdown over the
        last ``window_s`` seconds (runtime/accounting.py)."""
        return self.acct.snapshot(window_s)

    # ------------------------------------------------------------------
    # the loop and its supervisor
    # ------------------------------------------------------------------
    def _loop(self):
        while not self._stop:
            try:
                self._step()
            except Exception as e:  # noqa: BLE001 — the loop is the boundary
                traceback.print_exc(file=sys.stderr)
                FLIGHT.record("engine_failure", error=str(e)[:200],
                              consecutive=self._consecutive_failures + 1)
                self._consecutive_failures += 1
                final = self._consecutive_failures > self.max_restarts
                # no replay on the terminal failure: a recovering stream
                # would only be errored again by the drain below
                self._fail_running(str(e) or repr(e), replay=not final)
                if final:
                    with self._lock:
                        self.broken = f"scheduler loop failed: {e!r}"
                        for req in self._detach_all():
                            req.out.put(("error", f"engine failed: {e}"))
                    return
                self._supervised_restart()

    def _supervised_restart(self):
        """Reset the engine's slot state in-process after a failed step:
        every slot released (a parked prefix's cache is unknown now), the
        radix tree dropped, fenced pages returned, a capped exponential
        backoff, then the replayable streams re-admit ahead of the line
        through the preempt/resume path. The weights are untouched."""
        for slot in range(self.engine.n_slots):
            try:
                self.engine.release(slot)
            except Exception:  # noqa: BLE001 — best-effort teardown
                pass
        self._parked.clear()
        try:
            self.engine.radix_reset()
            self.engine.drain_quarantine()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass
        self.n_restarts += 1
        METRICS.inc("tpu_model_engine_restarts_total")
        FLIGHT.record("restart", n=self.n_restarts,
                      consecutive=self._consecutive_failures)
        FLIGHT.dump(f"supervised restart #{self.n_restarts}")
        delay = min(self.restart_backoff
                    * (2 ** (self._consecutive_failures - 1)),
                    self.RESTART_BACKOFF_CAP)
        t_end = time.monotonic() + max(0.0, delay)
        while not self._stop and time.monotonic() < t_end:
            time.sleep(min(0.02, max(0.0, t_end - time.monotonic())))
        if self._recovering:
            recov, self._recovering = self._recovering, []
            self._preempted[:0] = recov
            FLIGHT.record("replay_readmit", n=len(recov))
            self._wake.set()

    @staticmethod
    def _replay_ineligible(req: Request) -> Optional[str]:
        """Why a stream cannot replay to the same tokens, or None. Greedy
        streams and seeded ones (a draw keyed on (seed, position)) resume
        identically through the preempt/resume path; an unseeded sampled
        stream seeds from (slot, prompt length), both of which change, and
        a mirostat stream's budget restarts at 2·tau. A multimodal prompt
        cannot re-prefill from token ids at all."""
        if req.embeds is not None:
            return "multimodal"
        if req.opts.temperature > 0.0 and req.opts.seed < 0:
            return "nondeterministic"
        if req.opts.mirostat:
            return "nondeterministic"
        return None

    def _fail_running(self, message: str, replay: bool = True):
        """Classify the requests a failed step held: replayable streams
        (within TPU_RESTART_REPLAY_MAX streams and TPU_RESTART_REPLAY_TOKENS
        tokens) move to _recovering with prompt + generated as their
        resume ids; every other one gets exactly one error frame."""
        FLIGHT.record("fail_running", error=message[:200],
                      n_running=self.n_active)
        self._prefilling.clear()
        budget = replay_token_budget()
        max_streams = replay_max_streams() if replay else 0
        taken = 0
        for slot, req in enumerate(self._running):
            if req is None:
                continue
            self._running[slot] = None
            cause = self._replay_ineligible(req) if replay else "broken"
            cost = len(req.prompt_ids) + len(req.all_tokens)
            if cause is None and (taken >= max_streams or cost > budget):
                cause = "over_budget"
            if cause is None:
                try:
                    FAULTS.check("scheduler.replay")
                except InjectedFault:
                    cause = "faulted"
            if cause is None:
                budget -= cost
                taken += 1
                req.resume_ids = np.concatenate(
                    [req.prompt_ids, np.asarray(req.all_tokens, np.int64)])
                req.slot = None
                self._recovering.append(req)
                self.n_replays += 1
                METRICS.inc("tpu_model_replayed_requests_total")
                METRICS.inc("tpu_model_replayed_tokens_total", float(cost))
                req.trace.event("replay", slot=slot,
                                n_generated=req.stats.n_generated)
                FLIGHT.record("replay", rid=req.id, slot=slot,
                              outcome="recovered", tokens=cost,
                              n_generated=req.stats.n_generated)
            else:
                self.n_replay_fallbacks += 1
                METRICS.inc("tpu_model_replay_fallback_total",
                            labels=f'{{cause="{cause}"}}')
                FLIGHT.record("replay", rid=req.id, slot=slot,
                              outcome="fallback", cause=cause)
                self._request_error(req, message)
            try:
                self.engine.release(slot)
            except Exception:  # noqa: BLE001 — best-effort slot reset
                pass
        try:
            self.engine.drain_quarantine()
        except Exception:  # noqa: BLE001 — best-effort teardown
            pass

    def _step(self):
        self._reap_cancelled()
        self._shed_expired()
        self._throttle_over_limit()
        self._preempt_for_priority()
        self._advance_prefill()
        self._admit_waiting()
        if not self._decoding():
            if not self._prefilling:
                t_idle = time.perf_counter()
                self._wake.wait(0.05)
                self.acct.on_idle(time.perf_counter() - t_idle)
                self._wake.clear()
            return
        # a slot past its deadline ends before paying for a dispatch
        now = time.monotonic()
        for slot, req in self._decoding().items():
            if req.deadline is not None and now > req.deadline:
                METRICS.inc("tpu_model_request_timeouts_total")
                self._finish(slot, req, "timeout")
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
        hl = self.engine._host_lengths
        ctxs = [int(hl[s]) + 1 for s in snapshot]
        t0 = time.perf_counter()
        handle = self.engine.decode_n_launch(n)
        t_wait = time.perf_counter()
        toks = self._watched(handle.wait)
        t1 = time.perf_counter()
        self._consecutive_failures = 0
        self.engine.retire(handle.epoch)
        dur = t1 - t0
        METRICS.observe("tpu_model_dispatch_seconds", dur, '{kind="decode"}')
        self.acct.on_wait(t1 - t_wait)
        self.acct.on_decode(dur, ctxs, int(toks.shape[0]),
                            self.engine.n_slots)
        for slot, req in snapshot.items():
            if self._running[slot] is req:
                req.trace.event_at(t0, "dispatch", kind="decode",
                                   epoch=handle.epoch,
                                   dur_ms=round(dur * 1e3, 3))
                self._emit(slot, req, [int(t) for t in toks[:, slot]])

    def _decoding(self) -> Dict[int, Request]:
        """slot → request for every slot the next decode dispatch
        advances (slots mid-chunked-prefill are parked and excluded)."""
        return {s: r for s, r in enumerate(self._running)
                if r is not None and s not in self._prefilling}

    # ------------------------------------------------------------------
    # the hung-dispatch watchdog
    # ------------------------------------------------------------------
    def _watchdog_timeout_s(self) -> float:
        """The dispatch wait's budget in seconds; 0 turns the watchdog
        off. TPU_DISPATCH_WATCHDOG_MS wins (0 = off); else, once 64
        dispatches were observed, 100x their mean (clamped to 15..120 s),
        and 120 s before that."""
        ms = os.environ.get("TPU_DISPATCH_WATCHDOG_MS", "").strip()
        if ms:
            v = float(ms)
            return v / 1e3 if v > 0 else 0.0
        n, total = METRICS.hist_totals("tpu_model_dispatch_seconds")
        if n >= 64:
            return min(max(100.0 * (total / n), 15.0), 120.0)
        return 120.0

    @staticmethod
    def _wd_worker(req_q: queue.Queue, resp_q: queue.Queue):
        while True:
            fn = req_q.get()
            if fn is None:
                return
            try:
                resp_q.put((True, fn()))
            except BaseException as e:  # noqa: BLE001 — ferried to caller
                resp_q.put((False, e))

    def _watched(self, fn):
        """Run a blocking dispatch wait under the watchdog: the wait runs
        on a persistent helper thread while this thread waits on its
        answer with a timeout. On expiry the helper is abandoned (its late
        answer goes to queues nothing reads) and WatchdogTimeout takes the
        supervisor's path. The helper cannot cancel a kernel that hangs;
        a wedged card ends in broken, and the pod's liveness probe. The
        engine.watchdog fault point runs on the helper."""
        timeout = self._watchdog_timeout_s()
        if timeout <= 0:
            FAULTS.check("engine.watchdog")
            return fn()

        def task():
            FAULTS.check("engine.watchdog")
            return fn()

        if self._wd_thread is None or not self._wd_thread.is_alive():
            self._wd_req = queue.Queue()
            self._wd_resp = queue.Queue()
            self._wd_thread = threading.Thread(
                target=self._wd_worker, args=(self._wd_req, self._wd_resp),
                daemon=True, name="torch-dispatch-watchdog")
            self._wd_thread.start()
        self._wd_req.put(task)
        try:
            ok, val = self._wd_resp.get(timeout=timeout)
        except queue.Empty:
            self.n_watchdog_fires += 1
            METRICS.inc("tpu_model_watchdog_fires_total")
            FLIGHT.record("watchdog", timeout_s=round(timeout, 3),
                          fires=self.n_watchdog_fires)
            self._wd_req.put(None)      # it exits once its wait returns
            self._wd_thread = None      # never reuse its queues
            raise WatchdogTimeout(
                f"dispatch wait exceeded watchdog budget {timeout:.1f}s "
                f"(wedged device?)") from None
        if ok:
            return val
        raise val

    # ------------------------------------------------------------------
    # finishing and shedding
    # ------------------------------------------------------------------
    def _finish(self, slot: int, req: Request, reason: str,
                keep_cache: bool = True):
        """End ``req`` in ``slot``. On "stop" and "length" its cache is
        kept for reuse: with the radix cache the full-page prefix of
        everything but the last token (never fed back, so not cached) is
        donated; otherwise the slot is parked with those ids. A multimodal
        request's cache is never kept (its image positions' ids are pads
        that any other image shares)."""
        parkable = (list(req.prompt_ids) + req.all_tokens)[:-1]
        park = (keep_cache and req.embeds is None
                and reason in ("stop", "length") and len(parkable) > 0)
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
        req.stats.t_done = time.monotonic()
        self._avg_decode += 0.2 * (req.stats.n_generated - self._avg_decode)
        req.trace.event("finish", reason=reason, slot=slot,
                        n_generated=req.stats.n_generated)
        self._record_finished(req)
        req.out.put(("done", reason))

    def _record_finished(self, req: Request):
        with self._lock:
            self.finished.append(req.stats)
            if len(self.finished) > 512:
                self.finished = self.finished[-256:]

    def _request_error(self, req: Request, msg: str):
        """One terminal error frame for a request that never held, or just
        lost, a slot."""
        req.error = msg
        req.stats.t_done = time.monotonic()
        self._record_finished(req)
        req.out.put(("error", msg))

    def _observe_wait(self, req: Request):
        """A request's queue wait, observed once: at its first admission
        or when it is shed."""
        wait = max(time.monotonic() - req.stats.t_submit, 0.0)
        METRICS.observe("tpu_model_queue_wait_seconds", wait)
        METRICS.observe("tpu_model_class_queue_wait_seconds", wait,
                        f'{{class="{req.priority}"}}')

    def _shed(self, req: Request, cause: str = "deadline"):
        """Refuse a request that will never hold a slot: its deadline
        passed while it waited ("deadline"), or a higher class displaced
        it ("queue_full"). It got no token, so its reader raises
        DeadlineExceeded (503 + Retry-After)."""
        retry = self._retry_after_estimate(req.rank)
        req.error = ("deadline exceeded while queued" if cause == "deadline"
                     else "shed under queue pressure by a higher-priority "
                          "request")
        req.stats.t_done = time.monotonic()
        req.trace.event("shed", cause=cause)
        FLIGHT.record("shed", rid=req.id, cause=cause, cls=req.priority,
                      tenant=req.tenant, retry_after_s=retry)
        self._record_finished(req)
        self._observe_wait(req)
        METRICS.inc("tpu_model_requests_shed_total")
        METRICS.inc("tpu_model_shed_total",
                    labels=shed_labels(req.priority, cause))
        req.out.put(("shed", (req.error, retry)))

    def _timeout_waiting(self, req: Request):
        """A preempted or throttled request already streamed tokens: its
        expiry is a mid-generation timeout, not a shed."""
        METRICS.inc("tpu_model_request_timeouts_total")
        req.stats.t_done = time.monotonic()
        self._record_finished(req)
        req.out.put(("done", "timeout"))

    def _expire(self, req: Request):
        """A waiting request past its deadline: shed if it never streamed
        a token, else a timeout."""
        if req.resume_ids is not None:
            self._timeout_waiting(req)
        else:
            self._shed(req)

    def _shed_expired(self):
        """Drop waiting requests whose deadline passed or that were
        cancelled, move throttled requests whose debt drained back to the
        preempted line, and time out expired preempted ones."""
        now = time.monotonic()

        def expired(r):
            return r.deadline is not None and now > r.deadline

        for req in self._admission.sweep(
                lambda r: expired(r) or r.cancelled.is_set()):
            if req.cancelled.is_set():
                req.out.put(("done", "stop"))
            else:
                self._shed(req)
        for req in [r for r in self._throttled if r.resume_at <= now]:
            self._throttled.remove(req)
            self._preempted.append(req)
        for pool in (self._preempted, self._throttled):
            for req in [r for r in pool
                        if expired(r) or r.cancelled.is_set()]:
                pool.remove(req)
                if req.cancelled.is_set():
                    req.out.put(("done", "stop"))
                else:
                    self._timeout_waiting(req)

    def _reap_cancelled(self):
        for slot, req in enumerate(self._running):
            if req is not None and req.cancelled.is_set():
                if slot in self._prefilling:
                    self._abort_prefill(slot, "stop")
                else:
                    self._finish(slot, req, "stop", keep_cache=False)

    # ------------------------------------------------------------------
    # admission
    # ------------------------------------------------------------------
    def _next_waiting(self) -> Optional[Request]:
        """The head of the line: a preempted request before queued ones
        of its class (it held a place already), a queued higher class
        before it."""
        best_i = None
        for i, r in enumerate(self._preempted):
            if best_i is None or r.rank < self._preempted[best_i].rank:
                best_i = i
        qrank = self._admission.peek_rank()
        if best_i is not None:
            if qrank is None or self._preempted[best_i].rank <= qrank:
                return self._preempted.pop(best_i)
        return self._admission.pop()

    def _best_prefix(self, req: Request):
        """(slot, reuse_len) of the parked slot sharing the longest token
        prefix with the request, or (None, 0). One tail token must remain
        to prefill, the reuse must reach the floor, and the tail's bucket
        must fit above it. A multimodal request reuses nothing."""
        if self._use_radix or req.embeds is not None:
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
            got = self.engine.stitch(slot, ids, want)
        except PagesExhausted:
            self._evict_one_parked()
            return 0
        if got:
            req.trace.event("stitch", slot=slot, reused=got)
        return got

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

    def _expired_at_admission(self, req: Request) -> bool:
        """Deadline check at the moment a request would touch the engine
        (earlier admissions of this pass may have used its budget). True
        when the request was ended here."""
        if req.deadline is None or time.monotonic() <= req.deadline:
            return False
        self._expire(req)
        return True

    def _admit_waiting(self):
        while True:
            # slots mid-chunked-prefill are engine-inactive but taken
            free = [s for s in self.engine.free_slots()
                    if s not in self._prefilling]
            if not free:
                return
            req = self._next_waiting()
            if req is None:
                return
            if req.cancelled.is_set():
                req.out.put(("done", "stop"))
                continue
            if self._expired_at_admission(req):
                continue
            ids = req.admit_ids
            slot, reuse_len = self._best_prefix(req)
            if slot is None:
                slot = self._pick_slot(free, len(ids))
            # the slot's parked cache is spoken for either way
            self._parked.pop(slot, None)
            if self._use_radix and req.embeds is None:
                reuse_len = self._stitch_admission(slot, req)
            piece = self.prefill_chunk
            if (piece and len(ids) - reuse_len > piece
                    and req.embeds is None
                    and len(ids) + piece <= self.engine.max_seq):
                if not self._start_chunked(slot, req, reuse_len):
                    return
            elif not self._admit_one(slot, req, reuse_len):
                return

    def _requeue_dry(self, req: Request, err: Exception) -> bool:
        """A dry pool at admission: evict cached pages and put the request
        back at the head of the line (False), or fail it when no pool
        could ever hold it (True)."""
        if not self.engine.admissible(len(req.admit_ids)):
            self._request_error(req, f"prompt needs more KV pages than the "
                                     f"pool has: {err}")
            return True
        self._evict_one_parked(self._pages_for(len(req.admit_ids)))
        self._preempted.insert(0, req)
        return False

    def _prefill_done(self, req: Request, kind: str, t0: float,
                      start: int, n_new: int):
        """Account one prefill dispatch (a whole admission or a piece)."""
        dur = time.perf_counter() - t0
        METRICS.inc("tpu_model_admission_stall_ms_total", dur * 1e3)
        METRICS.observe("tpu_model_dispatch_seconds", dur,
                        f'{{kind="{kind}"}}')
        self.acct.on_prefill(dur, start, n_new,
                             self.engine.bucket_for(n_new))
        self.acct.on_wait(dur)
        req.trace.event("prefill", kind=kind, dur_ms=round(dur * 1e3, 3),
                        n_tokens=n_new)

    def _admit_one(self, slot: int, req: Request, reuse_len: int) -> bool:
        """One whole admission, cold or prefix-reusing. False when the
        pool ran dry and the request was requeued: stop admitting for
        this pass."""
        ids = req.admit_ids
        t0 = time.perf_counter()
        try:
            mask_row = (req.constraint.mask_row()
                        if req.constraint is not None else None)
            try:
                first = (self.engine.extend(slot, ids, reuse_len, req.opts,
                                            mask_row=mask_row)
                         if reuse_len else
                         self.engine.admit(slot, ids, req.opts,
                                           embeds=req.embeds,
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
            self._request_error(req, f"admission failed: {e}")
            return True
        self._prefill_done(req, "extend" if reuse_len else "admit", t0,
                           reuse_len, len(ids) - reuse_len)
        self._post_admit(slot, req, first)
        return True

    def _post_admit(self, slot: int, req: Request, first: int):
        """Shared tail of a whole admission and of a chunked one's last
        piece: the slot is taken, the reuse counted, and the first token
        delivered (for a constrained request: checked, then its mask
        installed)."""
        req.slot = slot
        if req.stats.t_admitted == 0:
            # first admission only: a re-admission's prompt was counted,
            # and its queue wait observed, already
            self.total_prompt += req.stats.n_prompt
            self._observe_wait(req)
        req.stats.t_admitted = time.monotonic()
        req.trace.event("admitted", slot=slot,
                        reused=int(req.stats.n_reused))
        FLIGHT.record("admit", rid=req.id, slot=slot,
                      n_prompt=int(req.stats.n_prompt),
                      reused=int(req.stats.n_reused))
        self._running[slot] = req
        n_re = min(req.stats.n_reused, len(req.admit_ids))
        self.prefix_hit_tokens += n_re
        self.prefix_miss_tokens += len(req.admit_ids) - n_re
        METRICS.inc("tpu_model_prefix_hit_tokens_total", float(n_re))
        METRICS.inc("tpu_model_prefix_miss_tokens_total",
                    float(len(req.admit_ids) - n_re))
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
        t0 = time.perf_counter()
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
            self._request_error(req, f"admission failed: {e}")
            return True
        self.n_prefill_pieces += 1
        METRICS.inc("tpu_model_prefill_chunks_total")
        self._prefill_done(req, "extend" if reuse_len else "admit", t0,
                           reuse_len, end - reuse_len)
        req.slot = slot
        self._running[slot] = req
        self._prefilling[slot] = _PrefillJob(req, end)
        return True

    def _abort_prefill(self, slot: int, reason: str):
        """A request ended mid-chunked-prefill: its slot's pages go back
        to the pool."""
        job = self._prefilling.pop(slot)
        self._running[slot] = None
        self.engine.release(slot)
        job.req.stats.t_done = time.monotonic()
        self._record_finished(job.req)
        job.req.out.put(("done", reason))

    def _advance_prefill(self):
        """One piece for the oldest chunked admission, at most one a
        scheduler step. The last piece samples the first token with the
        request's options (seeded from the slot and the full prompt
        length, as a whole admission's). An engine failure other than a
        dry pool goes to the supervisor."""
        if not self._prefilling:
            return
        slot = next(iter(self._prefilling))
        job = self._prefilling[slot]
        req = job.req
        if req.cancelled.is_set():
            self._abort_prefill(slot, "stop")
            return
        if req.deadline is not None and time.monotonic() > req.deadline:
            if req.resume_ids is None:
                # no token reached the client: a shed, not a timeout
                del self._prefilling[slot]
                self._running[slot] = None
                req.slot = None
                self.engine.release(slot)
                self._shed(req)
            else:
                METRICS.inc("tpu_model_request_timeouts_total")
                self._abort_prefill(slot, "timeout")
            return
        ids = req.admit_ids
        start = job.done
        end = min(job.done + self.prefill_chunk, len(ids))
        final = end == len(ids)
        t0 = time.perf_counter()
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
            req.slot = None
            self.engine.release(slot)
            self._evict_one_parked(self._pages_for(len(ids)))
            self._preempted.insert(0, req)
            return
        self.n_prefill_pieces += 1
        METRICS.inc("tpu_model_prefill_chunks_total")
        self._prefill_done(req, "extend", t0, start, end - start)
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
                req.trace.event("first_token")
            req.all_tokens.append(tid)
            if tid in req.eog_ids:
                if walk is not None:
                    # an EOG token escapes on the device: the slot froze
                    # after it
                    self._grammar_ack(slot, rest)
                reason = "stop"
                break
            req.stats.n_generated += 1
            self.total_generated += 1
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
            now = time.monotonic()
            if req._t_last_emit:
                METRICS.observe("tpu_model_itl_seconds",
                                max(now - req._t_last_emit, 0.0) / len(buf))
            req._t_last_emit = now
            # every class pays into its tenant's bucket; only best_effort
            # is throttled on debt
            self._limiter.debit(req.tenant, len(buf))
            METRICS.inc("tpu_model_tenant_decode_tokens_total",
                        float(len(buf)), f'{{tenant="{req.tenant}"}}')
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

    # -- preemption --------------------------------------------------------
    def _preempt_slot(self, slot: int, cause: str,
                      resume_delay: float = 0.0) -> Request:
        """Evict a running request from its slot; it re-admits from its
        prompt plus the tokens it generated and continues on the same
        stream. With ``resume_delay`` it waits in _throttled until its
        tenant's debt drains."""
        req = self._running[slot]
        self._running[slot] = None
        self.engine.release(slot)
        req.resume_ids = np.concatenate(
            [req.prompt_ids, np.asarray(req.all_tokens, np.int64)])
        req.slot = None
        self.n_preempted += 1
        METRICS.inc("tpu_model_preemptions_total")
        req.trace.event("preempted", slot=slot, cause=cause,
                        n_generated=req.stats.n_generated)
        FLIGHT.record("preempt", rid=req.id, slot=slot, cause=cause,
                      n_generated=req.stats.n_generated)
        if resume_delay > 0.0:
            req.resume_at = time.monotonic() + resume_delay
            self._throttled.append(req)
        else:
            self._preempted.append(req)
        return req

    def _relieve_pressure(self):
        """Make sure every decoding slot has pages for the next chunk:
        evict cached prefixes first, then preempt one running request at
        a time, the lowest class first and the newest admission within
        it. Multimodal requests go last (their embeddings cannot be
        re-prefilled from token ids): one that must go ends with an
        error."""
        while True:
            victims = self.engine.prepare_decode()
            if not victims:
                return
            if self._evict_one_parked():
                continue
            cand = [s for s in victims if self._running[s] is not None]
            if not cand:
                return  # nothing to act on; the dispatch will raise
            non_mm = [s for s in cand if self._running[s].embeds is None]
            if not non_mm:
                slot = cand[0]
                req = self._running[slot]
                self._running[slot] = None
                self.engine.release(slot)
                self._request_error(req, "preempted under KV-pool "
                                         "pressure; multimodal requests "
                                         "cannot resume")
                continue
            slot = max(non_mm, key=lambda s: (self._running[s].rank,
                                              self._running[s].stats
                                              .t_admitted))
            self._preempt_slot(slot, cause="pool_pressure")

    def _preempt_for_priority(self):
        """With every slot busy and a strictly higher class waiting,
        evict one lowest-class running request (the newest admission
        breaks ties), at most one a step (TPU_PRIORITY_PREEMPT)."""
        if not self._priority_preempt:
            return
        if any(s not in self._prefilling
               for s in self.engine.free_slots()):
            return
        ranks = [r.rank for r in self._preempted]
        qrank = self._admission.peek_rank()
        if qrank is not None:
            ranks.append(qrank)
        if not ranks:
            return
        want = min(ranks)
        cand = [s for s, r in enumerate(self._running)
                if r is not None and s not in self._prefilling
                and r.embeds is None and r.rank > want]
        if not cand:
            return
        slot = max(cand, key=lambda s: (self._running[s].rank,
                                        self._running[s].stats.t_admitted))
        self._preempt_slot(slot, cause="priority")

    def _throttle_over_limit(self):
        """Mid-stream rate limiting: a best_effort stream whose tenant's
        decode-token bucket is in debt is preempted and waits in
        _throttled until the debt drains. Higher classes are debited but
        never throttled."""
        if not self._limiter.enabled:
            return
        for slot, req in list(self._decoding().items()):
            if (req.priority != "best_effort" or req.embeds is not None
                    or req.stats.n_generated <= 0):
                continue
            delay = self._limiter.debt_delay(req.tenant)
            if delay <= 0.0:
                continue
            self.n_throttles += 1
            METRICS.inc(
                "tpu_model_tenant_throttles_total",
                labels=f'{{class="{req.priority}",tenant="{req.tenant}"}}')
            req.trace.event("throttled", tenant=req.tenant,
                            delay_ms=round(delay * 1e3, 1))
            FLIGHT.record("throttle", rid=req.id, slot=slot,
                          tenant=req.tenant, cls=req.priority,
                          delay_ms=round(delay * 1e3, 1))
            self._preempt_slot(slot, cause="throttle", resume_delay=delay)
