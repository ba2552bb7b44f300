"""The port's serving lifecycle on the CPU at the tiny preset (f32): request
deadlines, graceful drain, supervised restart with stream replay, the
hung-dispatch watchdog, and the pod's HTTP surface (probes, /metrics,
/debug/*, POST /api/drain, the /api/ps blocks, the SIGTERM sequence).

The contracts are the reference's own tests' (``tests/test_deadlines.py``,
``tests/test_admission.py``, ``tests/test_lifecycle.py``):

- a deadline that passes mid-generation ends the stream with
  ``done_reason`` "timeout" and exactly one terminal frame, and the slot
  serves the next request; one that passes while the request waits is a
  503 with ``Retry-After``;
- drain sheds new work with 503 + Retry-After while running streams
  finish; at its timeout a straggler ends with a "drain" frame;
- an injected mid-stream engine failure (a raised exception, or a wedged
  dispatch wait that the watchdog abandons) replays greedy and seeded
  streams token for token equal to an unfailed run, with no error frame,
  on the dense cache and on the paged pool;
- an unseeded sampled stream gets exactly one error frame instead;
- past ``TPU_ENGINE_MAX_RESTARTS`` consecutive failures the scheduler is
  broken and ``/livez`` and ``/readyz`` answer 503.
"""

import json
import os
import pathlib
import queue as queue_mod
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ollama_operator_tpu_torch.models import decoder
from ollama_operator_tpu_torch.models.config import PRESETS
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)
from ollama_operator_tpu_torch.runtime.errors import DeadlineExceeded
from ollama_operator_tpu_torch.runtime.faults import FAULTS
from ollama_operator_tpu_torch.runtime.scheduler import (Scheduler,
                                                         SchedulerBusy,
                                                         drain_timeout_s)
from ollama_operator_tpu_torch.runtime.service import LoadedModel
from ollama_operator_tpu_torch.server.__main__ import graceful_shutdown
from ollama_operator_tpu_torch.server.app import ModelManager, serve
from ollama_operator_tpu_torch.server.metrics import GLOBAL as METRICS
from ollama_operator_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
GREEDY = SlotOptions(temperature=0.0, repeat_penalty=1.0)
SEEDED = SlotOptions(temperature=0.9, seed=1234, repeat_penalty=1.0)
UNSEEDED = SlotOptions(temperature=0.9, repeat_penalty=1.0)
PROMPT = np.array([5, 6, 7])
BYTES = dict(tokens=[f"<0x{i:02X}>" for i in range(256)],
             token_types=[6] * 256)


@pytest.fixture(scope="module")
def params():
    return decoder.init_params(PRESETS["tiny"],
                               torch.Generator().manual_seed(0),
                               torch.float32, "cpu")


def _ecfg(slots, paged=False):
    extra = dict(paged=True, page_size=8) if paged else {}
    return EngineConfig(max_slots=slots, max_seq_len=64,
                        cache_dtype=torch.float32, min_prefill_bucket=16,
                        decode_chunk=4, **extra)


def _sched(params, slots=2, paged=False, **kw):
    eng = Engine(PRESETS["tiny"], params, _ecfg(slots, paged), device="cpu")
    return Scheduler(eng, **kw)


def _tokens(req):
    return [t for c in req.chunks() for t in c]


def _terminal(req):
    """The stream is over: nothing follows its one terminal frame."""
    with pytest.raises(queue_mod.Empty):
        req.out.get(timeout=0.2)


@pytest.fixture
def slow_steps():
    """Every decode dispatch takes 30 ms."""
    FAULTS.arm("engine.step", "delay:30ms")
    yield
    FAULTS.disarm("engine.step")


def _fail_decode_once(eng, fail_on=2):
    """The ``fail_on``-th decode dispatch raises; the others run."""
    calls = {"n": 0}
    real = eng.decode_n_launch

    def flaky(n=None):
        calls["n"] += 1
        if calls["n"] == fail_on:
            raise RuntimeError("injected mid-stream failure")
        return real(n)

    eng.decode_n_launch = flaky
    return calls


# -- deadlines ------------------------------------------------------------

def test_deadline_mid_generation_times_out_once(params, slow_steps):
    s = _sched(params, slots=1)
    to0 = METRICS.get("tpu_model_request_timeouts_total")
    try:
        r = s.submit(PROMPT, GREEDY, 500, deadline_s=0.15)
        out = _tokens(r)
        assert r.done_reason == "timeout" and 0 < len(out) < 55
        _terminal(r)
        assert METRICS.get("tpu_model_request_timeouts_total") == to0 + 1
        # the slot serves the next request
        assert len(_tokens(s.submit(PROMPT, GREEDY, 3))) == 3
    finally:
        s.shutdown()


def test_deadline_while_queued_sheds_with_retry_after(params, slow_steps):
    s = _sched(params, slots=1)
    try:
        run = s.submit(PROMPT, GREEDY, 40)
        next(run.chunks())
        r = s.submit([9, 9], GREEDY, 4, deadline_s=0.05)
        with pytest.raises(DeadlineExceeded) as e:
            _tokens(r)
        assert e.value.while_queued and e.value.retry_after_s >= 1
        _terminal(r)
    finally:
        s.shutdown()


# -- drain ----------------------------------------------------------------

def test_drain_sheds_new_work_and_running_completes(params, monkeypatch):
    monkeypatch.delenv("TPU_DRAIN_TIMEOUT_S", raising=False)
    assert drain_timeout_s() == 30.0
    s = _sched(params, slots=1)
    ds0 = METRICS.get("tpu_model_drain_started_total")
    try:
        r = s.submit(PROMPT, GREEDY, 12)
        it = r.chunks()
        next(it)
        s.begin_drain()
        s.begin_drain()                      # idempotent
        assert METRICS.get("tpu_model_drain_started_total") == ds0 + 1
        with pytest.raises(SchedulerBusy) as e:
            s.submit([9], GREEDY, 1)
        assert e.value.retry_after_s == 30
        assert sum(len(c) for c in it) >= 1
        assert r.done_reason == "length"
        assert s.lifecycle_stats()["state"] == "draining"
        assert s.drain(timeout_s=5) == 0
    finally:
        s.shutdown()


def test_drain_timeout_ends_stragglers(params, slow_steps):
    s = _sched(params, slots=1)
    try:
        run = s.submit(PROMPT, GREEDY, 500)
        it = run.chunks()
        next(it)
        waiting = s.submit([9], GREEDY, 4)
        assert s.drain(timeout_s=0.2) == 2
        list(it)
        assert run.done_reason == "drain"
        _terminal(run)
        with pytest.raises(DeadlineExceeded) as e:
            _tokens(waiting)
        assert e.value.while_queued
        assert s.n_active == 0 and not s.has_pending
    finally:
        s.shutdown()


# -- supervised restart and replay ----------------------------------------

def _reference(params, opts, paged, prompt=PROMPT, n=24):
    s = _sched(params, slots=2, paged=paged)
    try:
        return _tokens(s.submit(prompt, opts, n))
    finally:
        s.shutdown()


@pytest.mark.parametrize("paged", [False, True])
def test_replay_greedy_and_seeded_equal_an_unfailed_run(params, paged):
    refs = [_reference(params, GREEDY, paged),
            _reference(params, SEEDED, paged, prompt=[8, 1, 2])]
    s = _sched(params, slots=2, paged=paged, restart_backoff=0.0)
    rr0 = METRICS.get("tpu_model_replayed_requests_total")
    try:
        _fail_decode_once(s.engine, fail_on=3)
        reqs = [s.submit(PROMPT, GREEDY, 24),
                s.submit([8, 1, 2], SEEDED, 24)]
        assert [_tokens(r) for r in reqs] == refs
        for r in reqs:
            assert r.error is None and r.done_reason == "length"
            _terminal(r)
        assert (s.n_restarts, s.n_replays, s.n_replay_fallbacks) == (1, 2, 0)
        assert METRICS.get("tpu_model_replayed_requests_total") == rr0 + 2
        assert s.broken is None
        # and it serves new work
        assert len(_tokens(s.submit([4], GREEDY, 3))) == 3
        st = s.lifecycle_stats()
        assert (st["state"], st["restarts"]) == ("serving", 1)
        assert st["replay"]["replayed_streams"] == 2
    finally:
        s.shutdown()


def test_unseeded_stream_errors_exactly_once(params):
    s = _sched(params, slots=2, restart_backoff=0.0)
    fb0 = METRICS.get("tpu_model_replay_fallback_total",
                      '{cause="nondeterministic"}')
    try:
        _fail_decode_once(s.engine, fail_on=2)
        r = s.submit(PROMPT, UNSEEDED, 24)
        with pytest.raises(RuntimeError, match="injected"):
            _tokens(r)
        _terminal(r)
        assert s.n_replay_fallbacks == 1 and s.n_replays == 0
        assert METRICS.get("tpu_model_replay_fallback_total",
                           '{cause="nondeterministic"}') == fb0 + 1
    finally:
        s.shutdown()


def test_replay_fault_point_forces_the_error(params):
    s = _sched(params, slots=2, restart_backoff=0.0)
    try:
        _fail_decode_once(s.engine, fail_on=2)
        FAULTS.arm("scheduler.replay", "fail:once")
        r = s.submit(PROMPT, GREEDY, 24)
        with pytest.raises(RuntimeError):
            _tokens(r)
        assert s.n_replay_fallbacks == 1
    finally:
        FAULTS.disarm("scheduler.replay")
        s.shutdown()


def test_watchdog_fires_and_replay_recovers(params, monkeypatch):
    ref = _reference(params, GREEDY, False, n=12)
    monkeypatch.setenv("TPU_DISPATCH_WATCHDOG_MS", "300")
    s = _sched(params, slots=2, restart_backoff=0.0)
    wf0 = METRICS.get("tpu_model_watchdog_fires_total")
    try:
        assert s.lifecycle_stats()["watchdog"]["timeout_s"] == 0.3
        FAULTS.arm("engine.watchdog", "delay:3s:once")
        t0 = time.monotonic()
        r = s.submit(PROMPT, GREEDY, 12)
        assert _tokens(r) == ref
        assert time.monotonic() - t0 < 2.5     # abandoned, not waited out
        assert (s.n_watchdog_fires, s.n_restarts) == (1, 1)
        assert s.n_replays == 1 and r.error is None
        assert METRICS.get("tpu_model_watchdog_fires_total") == wf0 + 1
    finally:
        FAULTS.disarm("engine.watchdog")
        s.shutdown()


def test_watchdog_budget_knob(params, monkeypatch):
    s = _sched(params, slots=1)
    try:
        monkeypatch.setenv("TPU_DISPATCH_WATCHDOG_MS", "0")
        assert s._watchdog_timeout_s() == 0.0
        assert s._watched(lambda: 42) == 42
        monkeypatch.setenv("TPU_DISPATCH_WATCHDOG_MS", "2500")
        assert s._watchdog_timeout_s() == 2.5
        with pytest.raises(ValueError, match="boom"):
            s._watched(lambda: (_ for _ in ()).throw(ValueError("boom")))
        assert s._watched(lambda: "ok") == "ok"
        monkeypatch.delenv("TPU_DISPATCH_WATCHDOG_MS")
        assert 15.0 <= s._watchdog_timeout_s() <= 120.0
    finally:
        s.shutdown()


# -- the pod's HTTP surface ------------------------------------------------

def _lm(params, name="tiny", slots=1):
    return LoadedModel(name, PRESETS["tiny"], params,
                       Tokenizer(model="llama", **BYTES),
                       template="{{ .Prompt }}", device="cpu",
                       ecfg=_ecfg(slots))


def _http(port, path, body=None, headers=None):
    """(status, headers, body: parsed JSON, or text)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers=dict(headers or {}, **{"Content-Type": "application/json"}))
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            status, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    try:
        return status, hdrs, json.loads(raw)
    except ValueError:
        return status, hdrs, raw.decode()


def _gen(port, opts, prompt="hi", headers=None, stream=False):
    return _http(port, "/api/generate",
                 {"model": "tiny", "prompt": prompt, "stream": stream,
                  "options": dict({"temperature": 0}, **opts)}, headers)


def _prometheus(text):
    """name{labels} → value for every sample line; raises on a bad line."""
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        key, _, val = line.rpartition(" ")
        out[key] = float(val)
    return out


@pytest.fixture
def pod(params):
    mm = ModelManager(device="cpu")
    mm.add(_lm(params))
    httpd = serve(mm, "127.0.0.1", 0)
    try:
        yield mm, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()


def test_probes_metrics_traces_and_ps(pod, monkeypatch, slow_steps):
    mm, port = pod
    for path in ("/healthz", "/livez", "/readyz"):
        assert _http(port, path)[::2] == (200, "ok")
    status, _, out = _gen(port, {"num_predict": 6, "trace": True},
                          headers={"X-Tenant": "team-a"})
    assert status == 200 and out["eval_count"] == 6
    rid = out["timings"]["request_id"]
    spans = {s["ev"] for s in out["timings"]["spans"]}
    assert {"queued", "admitted", "first_token", "dispatch",
            "finish"} <= spans
    assert out["timings"]["queue_wait_ms"] >= 0
    _, _, tr = _http(port, f"/debug/trace?id={rid}")
    assert tr["tenant"] == "team-a" and tr["class"] == "normal"
    assert str(rid) in _http(port, "/debug/trace")[2]["ids"]
    assert _http(port, "/debug/trace?id=0")[0] == 404
    ev = _http(port, "/debug/events?kind=admit&last=1")[2]["events"]
    assert len(ev) == 1 and ev[0]["kind"] == "admit"
    _, _, util = _http(port, "/debug/utilization?last=5")
    assert util["model"] == "tiny" and util["snapshot"]["enabled"]
    status, hdrs, text = _http(port, "/metrics")
    assert status == 200 and hdrs["Content-Type"].startswith("text/plain")
    m = _prometheus(text)
    for key in ("tpu_model_requests_total", "tpu_model_generated_tokens_total",
                "tpu_model_requests_shed_total", "tpu_model_active_slots",
                'tpu_model_dispatch_seconds_count{kind="decode"}',
                'tpu_model_tenant_decode_tokens_total{tenant="team-a"}'):
        assert key in m, key
    assert m['tpu_model_tenant_decode_tokens_total{tenant="team-a"}'] >= 6
    ps = _http(port, "/api/ps")[2]["models"][0]
    assert ps["lifecycle"]["state"] == "serving"
    assert ps["admission"]["queued_by_class"] == {
        "high": 0, "normal": 0, "best_effort": 0}
    # the CPU has no peak: MFU reads null, as in the reference
    assert ps["utilization"]["mfu"] is None
    assert ps["utilization"]["totals"]["useful_tokens"]["decode"] > 0
    assert ps["failures"]["broken"] is False
    # a tenant over its queued cap: 429 with Retry-After
    monkeypatch.setenv("TPU_TENANT_MAX_QUEUED", "1")
    bg = [threading.Thread(target=_gen, args=(port, {"num_predict": 40}),
                           kwargs=dict(headers={"X-Tenant": "a"}))
          for _ in range(2)]
    for t in bg:
        t.start()
        time.sleep(0.15)
    status, hdrs, out = _gen(port, {"num_predict": 2},
                             headers={"X-Tenant": "a"})
    assert status == 429 and int(hdrs["Retry-After"]) >= 1
    assert out["error"] == "tenant 'a' already has 1 requests queued"
    # the API key names another (hashed) tenant, which is under its cap
    status, hdrs, out = _gen(port, {"num_predict": 2},
                             headers={"X-API-Key": "a"})
    assert status == 200
    for t in bg:
        t.join(timeout=30)


def test_drain_over_http_and_the_sigterm_sequence(pod, monkeypatch,
                                                  slow_steps):
    mm, port = pod
    results = []
    bg = threading.Thread(target=lambda: results.append(
        _gen(port, {"num_predict": 20}, stream=True)))
    bg.start()
    # the drain must find the stream running: wait for its admission
    # (a fixed sleep lost the race on a loaded host)
    sched = mm.resident()[0].scheduler
    deadline = time.monotonic() + 10
    while sched.n_active == 0 and time.monotonic() < deadline:
        time.sleep(0.01)
    status, _, out = _http(port, "/api/drain", {})
    assert status == 200 and out["status"] == "draining"
    assert out["active_streams"] == 1
    assert _http(port, "/readyz")[::2] == (503, "draining")
    assert _http(port, "/livez")[::2] == (200, "ok")
    status, hdrs, out = _gen(port, {"num_predict": 2})
    assert status == 503 and int(hdrs["Retry-After"]) >= 1
    assert out["error"] == "server draining"
    assert _http(port, "/api/ps")[2]["models"][0]["lifecycle"][
        "state"] == "draining"
    monkeypatch.setenv("TPU_DRAIN_TIMEOUT_S", "20")
    took = graceful_shutdown(mm, type("H", (), {
        "shutdown": lambda self: None, "server_close": lambda self: None})())
    bg.join(timeout=30)
    frames = [json.loads(x) for x in results[0][2].splitlines()]
    assert frames[-1]["done"] and frames[-1]["done_reason"] == "length"
    assert frames[-1]["eval_count"] == 20 and took < 20
    assert mm.resident() == []


def test_drain_straggler_gets_a_drain_frame(pod, monkeypatch, slow_steps):
    mm, port = pod
    results = []
    bg = threading.Thread(target=lambda: results.append(
        _gen(port, {"num_predict": 50}, stream=True)))
    bg.start()
    time.sleep(0.2)
    assert mm.drain(timeout_s=0.1) == 1
    bg.join(timeout=30)
    frames = [json.loads(x) for x in results[0][2].splitlines()]
    assert frames[-1]["done_reason"] == "drain"
    assert 0 < frames[-1]["eval_count"] < 50


def test_broken_engine_fails_the_probes(pod):
    mm, port = pod
    lm = mm.resident()[0]
    lm.scheduler.max_restarts = 1
    lm.scheduler.restart_backoff = 0.0

    def always_fail(n=None):
        raise RuntimeError("wedged")

    lm.engine.decode_n_launch = always_fail
    for _ in range(2):
        status, _, out = _gen(port, {"num_predict": 4, "seed": 3})
        assert status == 500 or "error" in out
    t0 = time.monotonic()
    while lm.scheduler.broken is None and time.monotonic() - t0 < 10:
        time.sleep(0.02)
    assert lm.scheduler.lifecycle_stats()["state"] == "broken"
    assert _http(port, "/livez")[::2] == (503, "engine failed")
    assert _http(port, "/readyz")[::2] == (503, "engine failed")
    assert _http(port, "/healthz")[0] == 200


def test_store_only_server_probes_and_sigterm(tmp_path):
    with socket.socket() as so:
        so.bind(("127.0.0.1", 0))
        port = so.getsockname()[1]
    env = {k: v for k, v in os.environ.items()
           if not k.lower().endswith("_proxy")}
    proc = subprocess.Popen(
        [sys.executable, "-m", "ollama_operator_tpu_torch.server",
         "--store-only", "--store", str(tmp_path / "store"), "--host",
         "127.0.0.1", "--port", str(port)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        t0 = time.monotonic()
        while True:
            try:
                if _http(port, "/healthz")[0] == 200:
                    break
            except OSError:
                assert time.monotonic() - t0 < 60 and proc.poll() is None
                time.sleep(0.1)
        assert _http(port, "/livez")[::2] == (200, "ok")
        assert _http(port, "/readyz")[::2] == (200, "ok")
        assert "tpu_model_requests_total" in _prometheus(
            _http(port, "/metrics")[2])
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        log = proc.stdout.read()
        assert "drain:" in log and "flight recorder dump: shutdown" in log
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
