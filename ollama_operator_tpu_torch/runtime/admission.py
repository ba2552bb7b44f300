"""Admission control and fair queuing: the overload discipline.

Counterpart of ``ollama_operator_tpu/runtime/admission.py`` (a copy: the
port imports nothing of the JAX package). Under sustained overload a
FIFO waiting queue answers the wrong question — it decides WHO waits by
arrival accident, lets one chatty
tenant starve everyone, and burns queue slots on requests that are
already guaranteed to miss their TTFT SLO. This module is the policy
object the scheduler's waiting line delegates to:

- **priority classes** (``high`` / ``normal`` / ``best_effort``):
  strict-priority dequeue; on queue pressure the lowest class sheds
  first (an incoming request displaces a strictly lower-priority one
  before it is itself rejected).
- **per-tenant weighted deficit round-robin** inside each class, over
  *token budgets* (prompt + predicted decode tokens), not request
  counts — a tenant submitting 4k-token prompts drains its deficit 4×
  faster than one submitting 1k-token prompts.
- **TTFT-SLO-aware early rejection**: a queue model (token backlog at
  equal-or-higher priority ÷ observed prefill+decode throughput from
  the dispatch histograms) predicts the queue wait; a request predicted
  to miss ``TPU_TTFT_SLO_MS`` is rejected at submit with a computed
  Retry-After instead of timing out after wasting a slot.
- **per-tenant decode-token rate limits**: a token bucket per tenant;
  best-effort requests of an over-rate tenant are throttled mid-stream
  (preempt + delayed resume on the same output stream).

All of this is host-side scheduler state.

Knobs (all env; request options and Modelfile defaults override where
noted):

    TPU_DEFAULT_PRIORITY        default class (options.priority >
                                Modelfile ``priority`` > this; "normal")
    TPU_TTFT_SLO_MS             TTFT SLO for early rejection
                                (options.ttft_slo_ms > Modelfile > env;
                                0/unset disables)
    TPU_TENANT_WEIGHTS          "teamA=2,teamB=1" WDRR weights
                                (default weight 1)
    TPU_WDRR_QUANTUM            deficit top-up per round, tokens (256)
    TPU_TENANT_MAX_QUEUED       per-tenant queued-request cap → HTTP 429
                                (0/unset disables)
    TPU_TENANT_TOKEN_RATE       decode tokens/s per tenant (0 disables);
                                per-tenant overrides via
                                TPU_TENANT_LIMITS="teamA=50,teamB=100"
    TPU_TENANT_BURST_S          token-bucket burst depth, seconds of
                                rate (2.0)
    TPU_ADMIT_THROUGHPUT_TPS    fixed throughput estimate override for
                                the queue model (tests/bench; unset =
                                derive from dispatch histograms)
"""

from __future__ import annotations

import hashlib
import math
import os
import re
import threading
import time
from collections import OrderedDict, deque
from typing import Dict, List, Optional, Tuple

from ..server.metrics import GLOBAL as METRICS
from .errors import BadRequest
from .faults import FAULTS

# strict-priority order: rank 0 dequeues first, rank 2 sheds first
PRIORITIES: Tuple[str, ...] = ("high", "normal", "best_effort")
PRIORITY_RANK: Dict[str, int] = {p: i for i, p in enumerate(PRIORITIES)}
DEFAULT_TENANT = "default"

# shed causes exported on tpu_model_shed_total{class,cause} (metrics.py
# pre-seeds every class × cause combination at 0)
SHED_CAUSES: Tuple[str, ...] = ("queue_full", "deadline", "slo_predict",
                                "tenant_cap")

_TENANT_RE = re.compile(r"^[A-Za-z0-9._:-]{1,64}$")


class TenantRateLimited(RuntimeError):
    """A tenant exceeded its admission cap; maps to HTTP 429.

    Distinct from SchedulerBusy (503): the server has capacity, this
    caller specifically is over its share — backing off other tenants
    would not help, so load balancers must not treat it as backpressure.
    """

    def __init__(self, msg: str, *, retry_after_s: int = 1):
        super().__init__(msg)
        self.retry_after_s = retry_after_s


def shed_labels(priority: str, cause: str) -> str:
    """Canonical label string for tpu_model_shed_total — keys sorted so
    reads (``METRICS.get``) and pre-seeds hit the same series."""
    return f'{{class="{priority}",cause="{cause}"}}'


# ----------------------------------------------------------------------
# option resolution (service.py side-channel pattern: merge_options
# drops unknown keys, so these read the raw dicts with the same
# request > Modelfile > env precedence as deadline_ms)
# ----------------------------------------------------------------------

def resolve_priority(defaults: Optional[Dict],
                     options: Optional[Dict]) -> str:
    o = dict(defaults or {})
    o.update(options or {})
    raw = o.get("priority")
    if raw is None:
        raw = os.environ.get("TPU_DEFAULT_PRIORITY") or None
    if raw is None:
        return "normal"
    p = str(raw).strip().lower()
    if p not in PRIORITY_RANK:
        raise BadRequest(
            f"invalid priority {raw!r}; expected one of "
            f"{'/'.join(PRIORITIES)}")
    return p


def resolve_tenant(options: Optional[Dict]) -> str:
    """``options.tenant`` (the HTTP layer injects one derived from the
    API-key header when the body carries none), sanitised so it is safe
    as a Prometheus label value; everyone else shares the default
    bucket."""
    raw = (options or {}).get("tenant")
    if raw is None or raw == "":
        return DEFAULT_TENANT
    t = str(raw)
    if _TENANT_RE.match(t):
        return t
    # unprintable/oversised names still deserve a stable bucket — hash
    # instead of rejecting (a tenant id is routing state, not an error)
    return "t-" + hashlib.sha256(t.encode()).hexdigest()[:12]


def tenant_from_key(header_value: str) -> str:
    """API-key/Authorization header → stable anonymous tenant id. The
    key itself must never appear in metrics labels or logs."""
    v = header_value.strip()
    for prefix in ("Bearer ", "Basic "):
        if v.startswith(prefix):
            v = v[len(prefix):].strip()
    if not v:
        return DEFAULT_TENANT
    return "key-" + hashlib.sha256(v.encode()).hexdigest()[:12]


def resolve_ttft_slo_s(defaults: Optional[Dict],
                       options: Optional[Dict]) -> Optional[float]:
    """TTFT SLO in seconds for early rejection, or None when disabled.
    Precedence: request ``ttft_slo_ms`` > Modelfile > TPU_TTFT_SLO_MS."""
    o = dict(defaults or {})
    o.update(options or {})
    raw = o.get("ttft_slo_ms")
    if raw is None:
        raw = os.environ.get("TPU_TTFT_SLO_MS") or None
    if raw is None:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid ttft_slo_ms: {raw!r}") from e
    if ms < 0:
        raise BadRequest("ttft_slo_ms must be >= 0")
    return ms / 1000.0 if ms > 0 else None


def _parse_kv_floats(env: str) -> Dict[str, float]:
    out: Dict[str, float] = {}
    for part in os.environ.get(env, "").split(","):
        part = part.strip()
        if not part:
            continue
        k, _, v = part.partition("=")
        try:
            out[k.strip()] = float(v)
        except ValueError:
            continue   # a malformed weight must not take the server down
    return out


# ----------------------------------------------------------------------
# queue model: predicted queue wait for early rejection
# ----------------------------------------------------------------------

def observed_throughput_tps(tokens_done: float) -> float:
    """Tokens/s the engine has actually sustained: total tokens through
    the engine ÷ total device busy-time from the dispatch-latency
    histograms (every prefill and decode dispatch observes into
    tpu_model_dispatch_seconds). 0.0 = no signal yet (cold server) —
    callers must admit optimistically on 0."""
    env = os.environ.get("TPU_ADMIT_THROUGHPUT_TPS", "")
    if env:
        try:
            return max(float(env), 0.0)
        except ValueError:
            pass
    _n, busy_s = METRICS.hist_totals("tpu_model_dispatch_seconds")
    if busy_s <= 0.05 or tokens_done <= 0:
        return 0.0
    return tokens_done / busy_s


def predict_queue_wait_s(backlog_tokens: float,
                         tokens_done: float) -> float:
    """Queue model: tokens queued ahead (at equal-or-higher priority) ÷
    observed throughput. Deliberately simple — it only has to be right
    about requests that are OBVIOUSLY doomed; borderline calls are
    admitted and covered by the deadline machinery."""
    FAULTS.check("admission.predict")
    if backlog_tokens <= 0:
        return 0.0
    tps = observed_throughput_tps(tokens_done)
    if tps <= 0:
        return 0.0
    return backlog_tokens / tps


def retry_after_s(predicted_wait_s: float, slo_s: float,
                  tps: float) -> int:
    """Computed Retry-After: when the backlog ahead should have drained
    enough for a fresh arrival to fit inside the SLO. Monotone in the
    predicted wait, clamped to [1, 120]."""
    excess = max(predicted_wait_s - max(slo_s, 0.0), 0.0)
    return int(min(max(math.ceil(excess + 1e-9), 1), 120))


# ----------------------------------------------------------------------
# per-tenant decode-token rate limiting (mid-stream throttling)
# ----------------------------------------------------------------------

class TenantRateLimiter:
    """Token bucket per tenant over DECODE tokens. ``debit`` is called
    from the scheduler's fan-out as tokens are delivered; a bucket in
    debt answers a positive ``debt_delay`` and the scheduler throttle-
    preempts that tenant's best-effort slots until the bucket refills.
    Disabled (zero overhead beyond one attribute check) unless
    TPU_TENANT_TOKEN_RATE is set."""

    def __init__(self, rate_tps: float = 0.0,
                 overrides: Optional[Dict[str, float]] = None,
                 burst_s: float = 2.0):
        self.rate = max(rate_tps, 0.0)
        self.overrides = dict(overrides or {})
        self.burst_s = max(burst_s, 0.1)
        self.enabled = self.rate > 0 or any(
            v > 0 for v in self.overrides.values())
        self._lock = threading.Lock()
        # tenant → (tokens available, last refill stamp)
        self._buckets: Dict[str, Tuple[float, float]] = {}

    @classmethod
    def from_env(cls) -> "TenantRateLimiter":
        try:
            rate = float(os.environ.get("TPU_TENANT_TOKEN_RATE", "0") or 0)
        except ValueError:
            rate = 0.0
        try:
            burst = float(os.environ.get("TPU_TENANT_BURST_S", "2") or 2)
        except ValueError:
            burst = 2.0
        return cls(rate, _parse_kv_floats("TPU_TENANT_LIMITS"), burst)

    def _rate_for(self, tenant: str) -> float:
        return self.overrides.get(tenant, self.rate)

    def _refill(self, tenant: str, now: float) -> float:
        rate = self._rate_for(tenant)
        cap = rate * self.burst_s
        avail, last = self._buckets.get(tenant, (cap, now))
        avail = min(avail + (now - last) * rate, cap)
        self._buckets[tenant] = (avail, now)
        return avail

    def debit(self, tenant: str, n_tokens: int) -> None:
        if not self.enabled or self._rate_for(tenant) <= 0:
            return
        now = time.monotonic()
        with self._lock:
            avail = self._refill(tenant, now)
            self._buckets[tenant] = (avail - n_tokens, now)

    def debt_delay(self, tenant: str) -> float:
        """Seconds until this tenant's bucket is back above zero; 0.0
        when the tenant is within its rate (or unlimited)."""
        rate = self._rate_for(tenant)
        if not self.enabled or rate <= 0:
            return 0.0
        now = time.monotonic()
        with self._lock:
            avail = self._refill(tenant, now)
        if avail >= 0:
            return 0.0
        return -avail / rate


# ----------------------------------------------------------------------
# the waiting line itself
# ----------------------------------------------------------------------

class _ClassQueue:
    """One priority class: tenant → FIFO deque, served by weighted
    deficit round-robin over request token costs."""

    __slots__ = ("tenants", "deficit", "tokens")

    def __init__(self):
        self.tenants: "OrderedDict[str, deque]" = OrderedDict()
        self.deficit: Dict[str, float] = {}
        self.tokens = 0.0   # running token backlog of this class

    def __len__(self):
        return sum(len(d) for d in self.tenants.values())

    def push(self, req):
        dq = self.tenants.get(req.tenant)
        if dq is None:
            dq = self.tenants[req.tenant] = deque()
            # a tenant re-entering after idling starts with a clean
            # deficit (classic DRR: credit does not accrue while idle)
            self.deficit[req.tenant] = 0.0
        dq.append(req)
        self.tokens += req.cost

    def _drop_tenant_if_empty(self, tenant: str):
        if not self.tenants.get(tenant):
            self.tenants.pop(tenant, None)
            self.deficit.pop(tenant, None)

    def pop(self, weights: Dict[str, float], quantum: float):
        """WDRR dequeue: serve the front tenant while its deficit covers
        its head request's cost; otherwise top the deficit up by
        quantum × weight and rotate. Bounded: every full rotation adds
        at least one quantum to some tenant, so the loop terminates in
        O(max_cost / quantum) rotations."""
        if not self.tenants:
            return None
        for _ in range(16384):   # backstop, never hit in practice
            tenant, dq = next(iter(self.tenants.items()))
            head = dq[0]
            if self.deficit[tenant] >= head.cost:
                self.deficit[tenant] -= head.cost
                dq.popleft()
                self.tokens -= head.cost
                self._drop_tenant_if_empty(tenant)
                return head
            self.deficit[tenant] += quantum * weights.get(tenant, 1.0)
            self.tenants.move_to_end(tenant)
        # pathological cost/quantum ratio: force-serve the front tenant
        tenant, dq = next(iter(self.tenants.items()))
        head = dq.popleft()
        self.deficit[tenant] = 0.0
        self.tokens -= head.cost
        self._drop_tenant_if_empty(tenant)
        return head

    def newest(self):
        """(tenant, request) of the most recent arrival, for
        shed-lowest-first victim selection."""
        best = None
        for tenant, dq in self.tenants.items():
            r = dq[-1]
            if best is None or r.stats.t_submit > best[1].stats.t_submit:
                best = (tenant, r)
        return best

    def remove(self, req) -> bool:
        dq = self.tenants.get(req.tenant)
        if dq is None:
            return False
        try:
            dq.remove(req)
        except ValueError:
            return False
        self.tokens -= req.cost
        self._drop_tenant_if_empty(req.tenant)
        return True


class AdmissionQueue:
    """The scheduler's waiting line: strict priority across classes,
    WDRR token-budget fairness across tenants within a class, bounded at
    ``max_queue`` with shed-lowest-first displacement. Thread-safe (its
    own lock), mirroring the queue.Queue it replaces; it never touches
    request output queues or metrics — shedding side-effects stay in the
    scheduler so every shed path reads identically there."""

    def __init__(self, max_queue: int = 256,
                 weights: Optional[Dict[str, float]] = None,
                 quantum: Optional[float] = None):
        self.max_queue = max_queue
        self.weights = (_parse_kv_floats("TPU_TENANT_WEIGHTS")
                        if weights is None else dict(weights))
        if quantum is None:
            try:
                quantum = float(
                    os.environ.get("TPU_WDRR_QUANTUM", "256") or 256)
            except ValueError:
                quantum = 256.0
        self.quantum = max(quantum, 1.0)
        self._lock = threading.Lock()
        self._classes: List[_ClassQueue] = [
            _ClassQueue() for _ in PRIORITIES]

    def __len__(self):
        with self._lock:
            return sum(len(c) for c in self._classes)

    def empty(self) -> bool:
        return len(self) == 0

    def offer(self, req):
        """Try to enqueue. Returns ``(accepted, victim)``: accepted with
        no victim on space; accepted after evicting a strictly
        lower-priority ``victim`` (caller sheds it) under pressure;
        ``(False, None)`` when the incoming request itself is the lowest
        priority present — the caller rejects it."""
        with self._lock:
            if sum(len(c) for c in self._classes) < self.max_queue:
                self._classes[req.rank].push(req)
                return True, None
            # full: shed lowest-first — displace the newest request of
            # the lowest class strictly below the incoming one
            for rank in range(len(PRIORITIES) - 1, req.rank, -1):
                got = self._classes[rank].newest()
                if got is None:
                    continue
                _tenant, victim = got
                self._classes[rank].remove(victim)
                self._classes[req.rank].push(req)
                return True, victim
            return False, None

    def pop(self):
        """Strict-priority dequeue; WDRR inside the winning class."""
        with self._lock:
            for c in self._classes:
                req = c.pop(self.weights, self.quantum)
                if req is not None:
                    return req
            return None

    def peek_rank(self) -> Optional[int]:
        with self._lock:
            for rank, c in enumerate(self._classes):
                if c.tenants:
                    return rank
            return None

    def backlog_tokens(self, rank: int) -> float:
        """Token backlog queued at priority ``rank`` or better — the
        work a fresh arrival of that class must wait behind."""
        with self._lock:
            return sum(c.tokens for c in self._classes[:rank + 1])

    def queued_for(self, tenant: str) -> int:
        with self._lock:
            return sum(len(c.tenants.get(tenant, ()))
                       for c in self._classes)

    def sweep(self, pred) -> List:
        """Remove and return every queued request matching ``pred``
        (deadline/cancellation sweeps)."""
        out: List = []
        with self._lock:
            for c in self._classes:
                for tenant in list(c.tenants):
                    dq = c.tenants[tenant]
                    hit = [r for r in dq if pred(r)]
                    if not hit:
                        continue
                    keep = deque(r for r in dq if not pred(r))
                    c.tokens -= sum(r.cost for r in hit)
                    c.tenants[tenant] = keep
                    c._drop_tenant_if_empty(tenant)
                    out.extend(hit)
        return out

    def drain(self) -> List:
        """Remove and return everything (shutdown / broken drain)."""
        out: List = []
        with self._lock:
            for c in self._classes:
                for dq in c.tenants.values():
                    out.extend(dq)
                c.tenants.clear()
                c.deficit.clear()
                c.tokens = 0.0
        return out

    def stats(self) -> Dict:
        """Live snapshot for /api/ps: per-class queue depth and token
        backlog, distinct tenants queued."""
        with self._lock:
            tenants = set()
            for c in self._classes:
                tenants.update(c.tenants)
            return {
                "queued_by_class": {
                    p: len(self._classes[r])
                    for p, r in PRIORITY_RANK.items()},
                "backlog_tokens_by_class": {
                    p: int(self._classes[r].tokens)
                    for p, r in PRIORITY_RANK.items()},
                "tenants_queued": len(tenants),
                "wdrr_quantum": self.quantum,
            }
