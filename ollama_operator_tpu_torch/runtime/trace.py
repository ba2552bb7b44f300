"""Request-lifecycle tracing and the crash flight recorder.

Counterpart of ``ollama_operator_tpu/runtime/trace.py`` (stdlib only).
Two instruments:

1. **Per-request span timelines** (`RequestTrace`): every request carries an
   append-only event list stamping its path through the stack — queued →
   admit/stitch → each chunked-prefill piece → each decode dispatch → detok
   → HTTP flush. Appends are a single `list.append` of a tuple (atomic
   under the GIL, no lock), so tracing rides the decode path cheaply.

2. **Flight recorder** (`FlightRecorder`): a process-wide fixed-size ring
   of structured scheduler events (admissions, preemptions, sheds,
   restarts, replays, drains, watchdog fires, fault injections). On a
   supervised restart and at shutdown the ring is dumped as JSON lines to
   stderr, so the log shows what happened *before* a failure.

``TRACER`` and ``FLIGHT`` are this package's own objects: a process that
also imports the JAX package has two independent sets.
"""

from __future__ import annotations

import collections
import json
import os
import sys
import threading
import time
from typing import Any, Dict, List, Optional

# Kill switch: TPU_TRACE=0 swaps every begin() for the shared no-op trace.
# The flight recorder stays on regardless — it is the crash debugger, its
# cost is one deque append per *scheduler-level* event, not per token.
TRACE_ENABLED = os.environ.get("TPU_TRACE", "1") not in ("0", "false", "")

# How many finished request timelines the registry keeps for /debug/trace.
TRACE_KEEP = int(os.environ.get("TPU_TRACE_KEEP", "256"))

# Ring size of the flight recorder (structured events, not tokens).
FLIGHT_EVENTS = int(os.environ.get("TPU_FLIGHT_EVENTS", "512"))


class RequestTrace:
    """Span timeline for one request.

    Events are `(t_rel_s, name, fields)` tuples appended without a lock;
    `t_rel_s` is seconds since the trace began (perf_counter deltas, so
    spans subtract cleanly).  `fields` is a small dict or None.
    """

    __slots__ = ("rid", "t_wall", "_t0", "events", "cls", "tenant")

    def __init__(self, rid: str):
        self.rid = rid
        self.t_wall = time.time()
        self._t0 = time.perf_counter()
        self.events: List[tuple] = []
        # admission identity (priority class / tenant), set by the
        # scheduler at submit() so a slow span is attributable to a class
        self.cls: Optional[str] = None
        self.tenant: Optional[str] = None

    def set_identity(self, cls: Optional[str] = None,
                     tenant: Optional[str] = None) -> None:
        if cls:
            self.cls = cls
        if tenant:
            self.tenant = tenant

    def event(self, name: str, **fields: Any) -> None:
        self.events.append(
            (time.perf_counter() - self._t0, name, fields or None))

    def event_at(self, t_abs: float, name: str, **fields: Any) -> None:
        """Record an event stamped at an earlier perf_counter() reading
        (e.g. a dispatch *launch* observed only when the handle is waited)."""
        self.events.append((t_abs - self._t0, name, fields or None))

    def to_dict(self) -> Dict[str, Any]:
        evs = []
        for t, name, fields in list(self.events):
            e = {"t_ms": round(t * 1e3, 3), "ev": name}
            if fields:
                e.update(fields)
            evs.append(e)
        out = {"id": self.rid, "t_start_unix": self.t_wall, "events": evs}
        if self.cls:
            out["class"] = self.cls
        if self.tenant:
            out["tenant"] = self.tenant
        return out

    def timings(self) -> Dict[str, Any]:
        """Condensed per-stage summary for the opt-in `timings` block in the
        final NDJSON frame (options.trace=true)."""
        first: Dict[str, float] = {}
        last: Dict[str, float] = {}
        counts: Dict[str, int] = {}
        for t, name, _ in list(self.events):
            first.setdefault(name, t)
            last[name] = t
            counts[name] = counts.get(name, 0) + 1
        out: Dict[str, Any] = {
            "spans": [{"ev": k, "first_ms": round(first[k] * 1e3, 3),
                       "last_ms": round(last[k] * 1e3, 3), "n": counts[k]}
                      for k in first],
        }
        if "admitted" in first and "queued" in first:
            out["queue_wait_ms"] = round(
                (first["admitted"] - first["queued"]) * 1e3, 3)
        return out


class _NullTrace:
    """Shared no-op stand-in when TPU_TRACE=0: call sites never branch."""

    __slots__ = ()
    rid = ""
    events: List[tuple] = []
    cls: Optional[str] = None
    tenant: Optional[str] = None

    def set_identity(self, cls: Optional[str] = None,
                     tenant: Optional[str] = None) -> None:
        pass

    def event(self, name: str, **fields: Any) -> None:
        pass

    def event_at(self, t_abs: float, name: str, **fields: Any) -> None:
        pass

    def to_dict(self) -> Dict[str, Any]:
        return {"id": "", "events": []}

    def timings(self) -> Dict[str, Any]:
        return {"spans": []}


NULL_TRACE = _NullTrace()


class Tracer:
    """Bounded registry of recent request timelines, keyed by request id.

    begin() is called by the scheduler at submit(); the trace stays
    addressable through GET /debug/trace?id= until TRACE_KEEP newer
    requests push it out."""

    def __init__(self, keep: int = TRACE_KEEP):
        self._lock = threading.Lock()
        self._keep = max(1, keep)
        self._traces: "collections.OrderedDict[str, RequestTrace]" = \
            collections.OrderedDict()

    def begin(self, rid) -> RequestTrace:
        if not TRACE_ENABLED:
            return NULL_TRACE  # type: ignore[return-value]
        tr = RequestTrace(str(rid))
        with self._lock:
            self._traces[tr.rid] = tr
            while len(self._traces) > self._keep:
                self._traces.popitem(last=False)
        return tr

    def get(self, rid) -> Optional[RequestTrace]:
        with self._lock:
            return self._traces.get(str(rid))

    def ids(self) -> List[str]:
        with self._lock:
            return list(self._traces)


class FlightRecorder:
    """Fixed-size ring buffer of structured events; survives until dumped.

    Events are plain dicts `{"seq": n, "t_unix": ..., "kind": ..., **fields}`.
    record() takes one short lock (deque.append is atomic but the seq
    counter is not); dump() snapshots under the same lock then writes JSON
    lines outside it."""

    def __init__(self, maxlen: int = FLIGHT_EVENTS):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=max(16, maxlen))
        self._seq = 0
        self._dumps = 0

    def record(self, kind: str, **fields: Any) -> None:
        ev = {"seq": 0, "t_unix": round(time.time(), 6), "kind": kind}
        ev.update(fields)
        with self._lock:
            self._seq += 1
            ev["seq"] = self._seq
            self._events.append(ev)

    def snapshot(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._events)

    @property
    def seq(self) -> int:
        """Total events ever recorded (the ring keeps only the tail)."""
        return self._seq

    @property
    def dumps(self) -> int:
        return self._dumps

    def dump(self, reason: str, stream=None, last: int = 0) -> int:
        """Print the last `last` events (0 = all buffered) as JSON lines.

        Called from the supervisor restart path and at shutdown; writes to
        stderr by default so the pod's log captures it even when the process is
        about to be torn down.  Returns the number of events printed."""
        evs = self.snapshot()
        if last > 0:
            evs = evs[-last:]
        out = stream if stream is not None else sys.stderr
        with self._lock:
            self._dumps += 1
        try:
            out.write(f"--- flight recorder dump: {reason} "
                      f"({len(evs)} events) ---\n")
            for ev in evs:
                out.write(json.dumps(ev, default=str) + "\n")
            out.write(f"--- end flight recorder dump: {reason} ---\n")
            out.flush()
        except Exception:  # lint: allow(exception-hygiene): a broken stderr must never mask the original failure
            pass
        return len(evs)


TRACER = Tracer()
FLIGHT = FlightRecorder()
