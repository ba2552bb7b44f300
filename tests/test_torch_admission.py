"""The port's admission policy (``runtime/admission.py``) against the JAX
package's, and its contracts on the port's scheduler, on the CPU.

- the resolvers (``resolve_priority``, ``resolve_tenant``,
  ``tenant_from_key``, ``resolve_ttft_slo_s``) and the service's
  ``resolve_deadline_s``: the same value, or the same 400 message, as the
  JAX functions for each input and environment;
- ``AdmissionQueue``: a seeded sequence of offers (classes, tenants with
  weights, token costs), pops and sweeps gives the same acceptances,
  displaced victims, pop order, backlogs and stats as the JAX queue;
- ``TenantRateLimiter`` on a shared fake clock, and the queue model
  (``predict_queue_wait_s``, ``retry_after_s``, ``observed_throughput_tps``,
  ``shed_labels``), against the JAX ones;
- on the port's scheduler at the tiny preset (f32, dense cache), as the
  reference's ``tests/test_admission.py`` holds its own: a queued high
  request preempts a running best_effort one, a tenant over its queued
  cap is refused with ``TenantRateLimited``, a request predicted to miss
  its TTFT SLO with ``SchedulerOverloaded``, a full queue displaces its
  newest lowest-class request (shed with 503) before it refuses one, and
  a predictor fault fails open.

The JAX side here is pure Python: no JAX program is compiled.
"""

import time

import numpy as np
import pytest
import torch

from ollama_operator_tpu.runtime import admission as jadm
from ollama_operator_tpu.runtime.errors import BadRequest as JBadRequest
from ollama_operator_tpu.runtime.service import \
    resolve_deadline_s as jresolve_deadline_s
from ollama_operator_tpu_torch.models import decoder
from ollama_operator_tpu_torch.models.config import PRESETS
from ollama_operator_tpu_torch.runtime import admission as tadm
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)
from ollama_operator_tpu_torch.runtime.errors import (BadRequest,
                                                      DeadlineExceeded)
from ollama_operator_tpu_torch.runtime.faults import FAULTS
from ollama_operator_tpu_torch.runtime.scheduler import (Scheduler,
                                                         SchedulerBusy,
                                                         SchedulerOverloaded)
from ollama_operator_tpu_torch.runtime.service import resolve_deadline_s
from ollama_operator_tpu_torch.server.metrics import GLOBAL as METRICS

torch.set_num_threads(1)

GREEDY = SlotOptions(temperature=0.0, repeat_penalty=1.0)
VALUES = [None, 0, 250, "300", 1.5, -1, "-5", "abc", "", [1], True,
          "HIGH", " normal ", "best_effort", "bogus", 3]
ENV_KNOBS = ("TPU_DEFAULT_PRIORITY", "TPU_TTFT_SLO_MS",
             "TPU_REQUEST_DEADLINE_MS")


def _same(fn, jfn, *args):
    """fn and jfn give the same value, or the same 400 message."""
    try:
        want = jfn(*args)
    except JBadRequest as e:
        with pytest.raises(BadRequest) as got:
            fn(*args)
        assert str(got.value) == str(e)
        return "refused"
    assert fn(*args) == want
    return want


@pytest.mark.parametrize("env", [{}, {"TPU_DEFAULT_PRIORITY": "high",
                                      "TPU_TTFT_SLO_MS": "500",
                                      "TPU_REQUEST_DEADLINE_MS": "900"},
                                 {"TPU_DEFAULT_PRIORITY": "bogus"}])
def test_resolvers_match_the_reference(monkeypatch, env):
    for k in ENV_KNOBS:
        monkeypatch.delenv(k, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    seen = set()
    for v in VALUES:
        for defaults in ({}, {"priority": "best_effort", "ttft_slo_ms": 20,
                              "deadline_ms": 40}):
            opts = {"priority": v, "ttft_slo_ms": v, "deadline_ms": v}
            opts = {k: x for k, x in opts.items() if x is not None}
            seen.add(str(_same(tadm.resolve_priority, jadm.resolve_priority,
                               defaults, opts)))
            seen.add(str(_same(tadm.resolve_ttft_slo_s,
                               jadm.resolve_ttft_slo_s, defaults, opts)))
            seen.add(str(_same(resolve_deadline_s, jresolve_deadline_s,
                               defaults, opts)))
        assert tadm.resolve_tenant({"tenant": v}) == jadm.resolve_tenant(
            {"tenant": v})
    assert "refused" in seen and len(seen) > 5


def test_tenant_from_key_matches_the_reference():
    rng = np.random.default_rng(7)
    keys = ["Bearer sk-123", "Basic abc", "  plain-key ", "Bearer ", "",
            "x" * 200, "teamA", "név/ünicode"]
    keys += ["".join(chr(int(c)) for c in rng.integers(33, 126, 24))
             for _ in range(16)]
    for k in keys:
        assert tadm.tenant_from_key(k) == jadm.tenant_from_key(k)
        assert tadm.resolve_tenant({"tenant": k}) == jadm.resolve_tenant(
            {"tenant": k})
        assert k.strip() == "" or "sk-123" not in tadm.tenant_from_key(k)


class _Stats:
    def __init__(self, t):
        self.t_submit = t


class _Req:
    """What the admission queue reads of a request."""

    def __init__(self, rid, priority, tenant, cost, t):
        self.id, self.priority, self.tenant = rid, priority, tenant
        self.rank = jadm.PRIORITY_RANK[priority]
        self.cost = float(cost)
        self.stats = _Stats(t)


def _ids(reqs):
    return [r.id for r in reqs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_admission_queue_matches_the_reference(seed):
    """The same seeded sequence of offers, pops and sweeps on both queues
    (weighted tenants, a small bound, so displacement and WDRR rotation
    both happen)."""
    rng = np.random.default_rng(seed)
    weights = {"a": 2.0, "b": 1.0, "c": 0.5}
    qs = [tadm.AdmissionQueue(max_queue=6, weights=weights, quantum=96),
          jadm.AdmissionQueue(max_queue=6, weights=weights, quantum=96)]
    n_victims = n_refused = n_pops = 0
    for step in range(400):
        op = rng.random()
        if op < 0.6:
            pri = str(rng.choice(jadm.PRIORITIES))
            ten = str(rng.choice(["a", "b", "c", "d"]))
            cost = int(rng.integers(8, 400))
            got = [q.offer(_Req(step, pri, ten, cost, step)) for q in qs]
            (ok_t, vt), (ok_j, vj) = got
            assert ok_t == ok_j
            assert (vt and vt.id) == (vj and vj.id)
            n_victims += vj is not None
            n_refused += not ok_j
        elif op < 0.9:
            a, b = qs[0].pop(), qs[1].pop()
            assert (a and a.id) == (b and b.id)
            n_pops += b is not None
        else:
            k = int(rng.integers(2, 5))
            assert (_ids(qs[0].sweep(lambda r: r.id % k == 0))
                    == _ids(qs[1].sweep(lambda r: r.id % k == 0)))
        assert len(qs[0]) == len(qs[1])
        assert qs[0].peek_rank() == qs[1].peek_rank()
        assert qs[0].stats() == qs[1].stats()
        for rank in range(3):
            assert qs[0].backlog_tokens(rank) == qs[1].backlog_tokens(rank)
        for ten in "abcd":
            assert qs[0].queued_for(ten) == qs[1].queued_for(ten)
    assert _ids(qs[0].drain()) == _ids(qs[1].drain())
    assert n_victims and n_refused and n_pops > 50


def test_rate_limiter_matches_the_reference(monkeypatch):
    now = [1000.0]
    monkeypatch.setattr(time, "monotonic", lambda: now[0])
    lims = [tadm.TenantRateLimiter(20.0, {"big": 100.0, "off": 0.0}, 1.5),
            jadm.TenantRateLimiter(20.0, {"big": 100.0, "off": 0.0}, 1.5)]
    rng = np.random.default_rng(3)
    for _ in range(300):
        ten = str(rng.choice(["a", "big", "off", "z"]))
        if rng.random() < 0.6:
            n = int(rng.integers(1, 40))
            for lim in lims:
                lim.debit(ten, n)
        else:
            assert lims[0].debt_delay(ten) == lims[1].debt_delay(ten)
        now[0] += float(rng.random()) * 0.5
    assert lims[0].enabled and not tadm.TenantRateLimiter().enabled


def test_queue_model_matches_the_reference(monkeypatch):
    monkeypatch.setenv("TPU_ADMIT_THROUGHPUT_TPS", "1234.5")
    rng = np.random.default_rng(11)
    for backlog in [0, 1, 17.5] + list(rng.uniform(0, 1e6, 20)):
        done = float(rng.uniform(0, 1e5))
        assert (tadm.predict_queue_wait_s(backlog, done)
                == jadm.predict_queue_wait_s(backlog, done))
        assert (tadm.observed_throughput_tps(done)
                == jadm.observed_throughput_tps(done))
        for slo in (0.0, 0.05, 2.0, 500.0):
            w = float(backlog) / 1234.5
            assert (tadm.retry_after_s(w, slo, 1234.5)
                    == jadm.retry_after_s(w, slo, 1234.5))
    for p in jadm.PRIORITIES:
        for c in jadm.SHED_CAUSES:
            assert tadm.shed_labels(p, c) == jadm.shed_labels(p, c)
            # the port's registry pre-seeds each series
            assert f'tpu_model_shed_total{tadm.shed_labels(p, c)} ' in \
                METRICS.render()
    monkeypatch.delenv("TPU_ADMIT_THROUGHPUT_TPS")
    assert tadm.observed_throughput_tps(0.0) == 0.0


# -- the contracts on the port's scheduler ------------------------------

@pytest.fixture(scope="module")
def params():
    return decoder.init_params(PRESETS["tiny"],
                               torch.Generator().manual_seed(0),
                               torch.float32, "cpu")


def _sched(params, slots=1, **kw):
    eng = Engine(PRESETS["tiny"], params,
                 EngineConfig(max_slots=slots, max_seq_len=64,
                              cache_dtype=torch.float32,
                              min_prefill_bucket=16, decode_chunk=4),
                 device="cpu")
    return Scheduler(eng, **kw)


@pytest.fixture
def slow_steps():
    """Every decode dispatch takes 30 ms, so that streams overlap."""
    FAULTS.arm("engine.step", "delay:30ms")
    yield
    FAULTS.disarm("engine.step")


def test_high_request_preempts_best_effort(params, slow_steps):
    s = _sched(params, slots=1)
    try:
        low = s.submit([5, 6], GREEDY, 40, priority="best_effort")
        it = low.chunks()
        got = next(it)                             # running for sure
        high = s.submit([7, 8], GREEDY, 4, priority="high")
        out = [t for c in high.chunks() for t in c]
        assert len(out) == 4 and high.done_reason == "length"
        got += [t for c in it for t in c]
        assert low.done_reason == "length" and s.n_preempted >= 1
        assert high.stats.t_first_token < low.stats.t_done
        # the preempted stream resumed where it stopped: its greedy
        # tokens equal an undisturbed run of the same prompt
        ref = s.submit([5, 6], GREEDY, 40)
        assert [t for c in ref.chunks() for t in c] == got
    finally:
        s.shutdown()


def test_tenant_cap_slo_reject_and_displacement(params, monkeypatch,
                                                slow_steps):
    monkeypatch.setenv("TPU_TENANT_MAX_QUEUED", "2")
    monkeypatch.setenv("TPU_ADMIT_THROUGHPUT_TPS", "10")
    s = _sched(params, slots=1, max_queue=3)
    shed0 = METRICS.get("tpu_model_shed_total",
                        tadm.shed_labels("best_effort", "queue_full"))
    try:
        run = s.submit([1, 2], GREEDY, 40, tenant="x")
        next(run.chunks())
        q = [s.submit([3, 4], GREEDY, 4, tenant="a", priority="best_effort")
             for _ in range(2)]
        with pytest.raises(tadm.TenantRateLimited) as e:
            s.submit([3, 4], GREEDY, 4, tenant="a")
        assert e.value.retry_after_s >= 1
        # 2 x (2 + 4) tokens queued at its class or above at 10 tok/s:
        # a 1 ms SLO cannot hold
        with pytest.raises(SchedulerOverloaded) as e:
            s.submit([3, 4], GREEDY, 4, tenant="b", ttft_slo_s=0.001,
                     priority="best_effort")
        assert e.value.retry_after_s >= 1
        # a predictor fault fails open: admitted
        FAULTS.arm("admission.predict", "fail:once")
        ok = s.submit([3, 4], GREEDY, 4, tenant="b", ttft_slo_s=0.001,
                      priority="high")
        # the queue is full: a normal arrival displaces the newest
        # best_effort request, which is shed with 503
        s.submit([9], GREEDY, 2, tenant="c")
        with pytest.raises(DeadlineExceeded) as e:
            list(q[1].chunks())
        assert e.value.while_queued and e.value.retry_after_s >= 1
        # nothing lower left to displace at best_effort: refused
        with pytest.raises(SchedulerBusy):
            s.submit([9], GREEDY, 2, tenant="d", priority="best_effort")
        assert METRICS.get("tpu_model_shed_total", tadm.shed_labels(
            "best_effort", "queue_full")) >= shed0 + 2
        run.cancel()
        assert len([t for c in ok.chunks() for t in c]) == 4
        assert len([t for c in q[0].chunks() for t in c]) == 4
        st = s.admission_stats()
        assert st["shed_by_class"]["best_effort"] >= 2
        assert set(st["queued_by_class"]) == set(jadm.PRIORITIES)
    finally:
        FAULTS.disarm("admission.predict")
        s.shutdown()
