"""Deterministic fault injection for the serving lifecycle's tests.

Counterpart of ``ollama_operator_tpu/runtime/faults.py``, with the fault
points this package wires. Code under test calls ``FAULTS.check("<point>")``
at a named point; the check is a no-op (one dict lookup on an empty dict)
unless a rule was armed for that point through the test API or the
``TPU_FAULTS`` environment variable. Every wired point is registered in
``CATALOG`` with its call site and what an armed fail or delay simulates.

Trigger specs (the grammar is intentionally tiny):

    fail            -- raise InjectedFault on every hit
    fail:once       -- raise on the first hit, then disarm the point
    fail:n=K        -- raise on the first K hits, then disarm
    fail:every=K    -- raise on every K-th hit (hit K, 2K, ...)
    fail:after=K    -- pass K hits, then raise on every later hit
    delay:50ms      -- sleep 50ms on every hit (also: delay:0.2s)
    delay:50ms:once / :n=K / :every=K / :after=K
                    -- delays take the same trigger modes as fail, so a
                       drill can wedge exactly one dispatch

Env arming: ``TPU_FAULTS="engine.step=fail:once,engine.watchdog=delay:2s:once"``.
Faults are injected on the host only (a raised exception or a sleep),
never as a device fault: a sticky CUDA error poisons the context, and an
in-process restart cannot recover from it.
"""

from __future__ import annotations

import dataclasses
import os
import threading
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class FaultPoint:
    """One registered fault point: where it is wired and what it models."""

    name: str
    site: str    # repo-relative module holding the FAULTS.check call
    doc: str


CATALOG: Dict[str, FaultPoint] = {}


def point(name: str, site: str, doc: str) -> FaultPoint:
    """Register a fault point in the catalog (duplicate names are a bug)."""
    if name in CATALOG:
        raise ValueError(f"fault point {name!r} already registered")
    fp = FaultPoint(name, site, " ".join(doc.split()))
    CATALOG[name] = fp
    return fp


point("engine.step", "ollama_operator_tpu_torch/runtime/engine.py",
      """Top of Engine.decode_n_launch (the decode dispatch). An armed fail
      is a decode-loop failure: the scheduler's supervised restart
      replays the greedy and seeded streams and errors the others exactly
      once.""")
point("engine.watchdog", "ollama_operator_tpu_torch/runtime/scheduler.py",
      """Inside the scheduler's watchdog-bounded dispatch wait, on the
      waiter thread; an armed delay:Nms simulates a wedged device (the
      wait stalls, the watchdog fires, supervised restart + replay).""")
point("scheduler.replay", "ollama_operator_tpu_torch/runtime/scheduler.py",
      """Per replayable stream in _fail_running's restart classification;
      an armed fail forces the stream down the exactly-once error path
      (fallback cause="faulted").""")
point("admission.predict", "ollama_operator_tpu_torch/runtime/admission.py",
      """admission.predict_queue_wait_s (the TTFT queue model); an armed
      fail proves the predictor fails open: requests are admitted and
      covered by the deadline machinery, never 500ed.""")


class InjectedFault(RuntimeError):
    """Raised by an armed ``fail`` rule at a fault point."""

    def __init__(self, point: str, spec: str):
        super().__init__(f"injected fault at {point!r} ({spec})")
        self.point = point
        self.spec = spec


def _parse_mode(spec: str, arg: str) -> Tuple[str, float]:
    """Shared trigger-mode grammar: '' | once | n=K | every=K | after=K."""
    if not arg:
        return "always", 0.0
    if arg == "once":
        return "n", 1.0
    mode, _, val = arg.partition("=")
    if mode in ("n", "every", "after") and val:
        k = int(val)
        if k < 1:
            raise ValueError(f"fault spec {spec!r}: count must be >= 1")
        return mode, float(k)
    raise ValueError(f"unknown fault spec {spec!r}")


def _parse_spec(spec: str) -> Tuple[str, Optional[str], float, float]:
    """Return (kind, mode, count, seconds): kind in {fail, delay};
    ``seconds`` is the sleep for delay rules (0 for fail)."""
    spec = spec.strip()
    kind, _, arg = spec.partition(":")
    kind = kind.strip()
    arg = arg.strip()
    if kind == "fail":
        mode, count = _parse_mode(spec, arg)
        return "fail", mode, count, 0.0
    if kind == "delay":
        dur, _, modearg = arg.partition(":")
        dur = dur.strip()
        if dur.endswith("ms"):
            seconds = float(dur[:-2]) / 1000.0
        elif dur.endswith("s"):
            seconds = float(dur[:-1])
        else:
            raise ValueError(f"delay spec {spec!r} needs a ms/s suffix")
        mode, count = _parse_mode(spec, modearg.strip())
        return "delay", mode, count, seconds
    raise ValueError(f"unknown fault spec {spec!r}")


class FaultInjector:
    """Registry of armed fault rules, keyed by fault-point name."""

    def __init__(self):
        self._lock = threading.Lock()
        # point -> (spec string, kind, mode, count, seconds)
        self._rules: Dict[str, Tuple[str, str, str, float, float]] = {}
        self._counts: Dict[str, int] = {}

    def arm(self, point: str, spec: str) -> None:
        rule = _parse_spec(spec)
        with self._lock:
            self._rules[point] = (spec, *rule)
            self._counts[point] = 0

    def disarm(self, point: str) -> None:
        with self._lock:
            self._rules.pop(point, None)

    def reset(self) -> None:
        with self._lock:
            self._rules.clear()
            self._counts.clear()

    def hits(self, point: str) -> int:
        with self._lock:
            return self._counts.get(point, 0)

    def points(self) -> List[FaultPoint]:
        """The full registered fault-point catalog, sorted by name."""
        return [CATALOG[n] for n in sorted(CATALOG)]

    def check(self, point: str) -> None:
        """Call at a fault point. No-op unless a rule is armed for it."""
        if not self._rules:  # fast path: nothing armed anywhere
            return
        with self._lock:
            rule = self._rules.get(point)
            if rule is None:
                return
            n = self._counts.get(point, 0) + 1
            self._counts[point] = n
            spec, kind, mode, count, seconds = rule
            if mode == "always":
                fire = True
            elif mode == "n":
                fire = n <= count
                if n >= count:
                    del self._rules[point]
            elif mode == "every":
                fire = n % int(count) == 0
            else:  # after
                fire = n > count
        # act outside the lock so a sleep never blocks other points
        if kind == "fail":
            if fire:
                # flight-recorder breadcrumb BEFORE the raise: a chaos
                # drill's post-mortem dump must show the injected fault
                # ahead of the failure cascade it triggers
                from .trace import FLIGHT
                FLIGHT.record("fault_injected", point=point, spec=spec,
                              hit=n)
                raise InjectedFault(point, spec)
            return
        if fire and seconds > 0:
            from .trace import FLIGHT
            FLIGHT.record("fault_injected", point=point, spec=spec,
                          hit=n)
            time.sleep(seconds)

    def arm_from_env(self, env: str = "TPU_FAULTS") -> None:
        raw = os.environ.get(env, "")
        for part in raw.split(","):
            part = part.strip()
            if not part:
                continue
            point, _, spec = part.partition("=")
            self.arm(point.strip(), spec.strip())


FAULTS = FaultInjector()
FAULTS.arm_from_env()
