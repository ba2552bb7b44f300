"""The port's chunked prefill (Sarathi-style pieces) on the CPU.

- a prompt of 3.5 pieces admitted while two slots decode: every stream
  equals the JAX scheduler's with the same ``prefill_chunk``; the port
  prefills it in 4 pieces with a decode dispatch between each two, while
  the decoding slots run;
- a request cancelled between pieces frees its slot's pages;
- ``TPU_PREFILL_CHUNK`` is read as the reference reads it (unset:
  decode_chunk * 8 rounded up to a bucket; 0: every prompt whole).
"""

import threading
import time

import numpy as np
import pytest
import torch

from ollama_operator_tpu.runtime.engine import Engine as JEngine
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import SlotOptions as JSlotOptions
from ollama_operator_tpu.runtime.scheduler import Scheduler as JScheduler
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)
from ollama_operator_tpu_torch.runtime.scheduler import Scheduler
from test_torch_prefix import JCFG, PS, TCFG, _port_page_accounting, params

torch.set_num_threads(1)

__all__ = ["_port_page_accounting", "params"]

GREEDY = dict(temperature=0.0)
COMMON = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
              paged=True, page_size=PS)


def port_engine(params, **kw):
    return Engine(TCFG, params[1], EngineConfig(
        **{**COMMON, "cache_dtype": torch.int8, "decode_chunk": 4, **kw}),
        device="cpu")


def log_calls(eng, names):
    """Wrap the engine's ``names`` to append (name, call) to a list."""
    calls = []
    for name in names:
        fn = getattr(eng, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        setattr(eng, name, wrapped)
    return calls


def run_mix(sched, opts):
    """Two short requests decode; once both streamed a token, a 56-token
    prompt (3.5 pieces of 16) arrives. Returns the three streams."""
    rng = np.random.default_rng(1)
    short = [list(rng.integers(1, 250, 10)) for _ in range(2)]
    long_ = list(rng.integers(1, 250, 56))
    decoders = [sched.submit(p, opts, max_tokens=24) for p in short]
    streams = [[] for _ in range(3)]
    firsts = [threading.Event(), threading.Event()]

    def read(i, req):
        for chunk in req.chunks():
            streams[i].extend(chunk)
            if i < 2:
                firsts[i].set()

    ts = [threading.Thread(target=read, args=(i, r))
          for i, r in enumerate(decoders)]
    for t in ts:
        t.start()
    for e in firsts:
        assert e.wait(60)
    long_req = sched.submit(long_, opts, max_tokens=6)
    ts.append(threading.Thread(target=read, args=(2, long_req)))
    ts[-1].start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts)
    return streams


def test_chunked_streams_match_jax_scheduler(params):
    je = JEngine(JCFG, params[0], ecfg=JEngineConfig(
        cache_dtype=np.int8, decode_chunk=4, **COMMON))
    jsched = JScheduler(je, prefill_chunk=16)
    try:
        assert jsched.prefill_chunk == 16
        want = run_mix(jsched, JSlotOptions(**GREEDY))
    finally:
        jsched.shutdown()
    te = port_engine(params)
    calls = log_calls(te, ("admit", "extend", "decode_n_launch"))
    sched = Scheduler(te, prefill_chunk=16)
    try:
        got = run_mix(sched, SlotOptions(**GREEDY))
        assert sched.n_prefill_pieces == 4
    finally:
        sched.shutdown()
    assert got == want
    assert [len(s) for s in got] == [24, 24, 6]
    # the long prompt's pieces: its first (an admit at 16 tokens) and
    # three extends, a decode dispatch between each two
    first = calls.index("admit", 2)
    pieces = [i for i, c in enumerate(calls) if c in ("admit", "extend")
              and i >= first]
    assert len(pieces) == 4
    for a, b in zip(pieces, pieces[1:]):
        assert "decode_n_launch" in calls[a + 1:b]
    te._pt.check()


def test_cancel_during_prefill_frees_pages(params):
    te = port_engine(params)
    sched = Scheduler(te, prefill_chunk=16)
    real = te.extend
    seen = []

    def extend(*a, **kw):
        seen.append(1)
        req.cancel()                 # between the first and second piece
        return real(*a, **kw)
    te.extend = extend
    try:
        req = sched.submit(list(range(1, 57)), SlotOptions(**GREEDY),
                           max_tokens=4)
        assert list(req.tokens()) == []
        t1 = time.monotonic() + 10
        while sched.has_pending and time.monotonic() < t1:
            time.sleep(0.01)
        assert not sched.has_pending and seen
        assert sched.n_prefill_pieces < 4
        assert te._pt.n_free == te._pt.data_pages - te.radix_pages
        assert te.radix_pages == 0          # a cancel donates nothing
    finally:
        sched.shutdown()


def test_prefill_chunk_knob(params, monkeypatch):
    for env, want in (("", 32), ("0", 0), ("20", 32), ("70", 128)):
        monkeypatch.setenv("TPU_PREFILL_CHUNK", env)
        sched = Scheduler(port_engine(params, min_prefill_bucket=16))
        try:
            # unset: decode_chunk (4) * 8 = 32, a bucket already
            assert sched.prefill_chunk == want, env
        finally:
            sched.shutdown()
    monkeypatch.setenv("TPU_PREFILL_CHUNK", "0")
    te = port_engine(params)
    sched = Scheduler(te)
    try:
        req = sched.submit(list(range(1, 100)), SlotOptions(**GREEDY),
                           max_tokens=3)
        assert len(list(req.tokens())) == 3
        assert sched.n_prefill_pieces == 0
    finally:
        sched.shutdown()


@pytest.mark.parametrize("piece", [16, 32])
def test_chunked_equals_one_shot(params, piece):
    """A 90-token prompt admitted in pieces decodes what it decodes when
    admitted whole (pieces of 16 and 32 against TPU_PREFILL_CHUNK=0;
    chunking needs the prompt plus a piece within the context). An f32
    pool: on a quantized pool the later pieces attend the earlier ones'
    rounded K/V, which a whole admission never reads, in the reference as
    in the port."""
    prompt = list(np.random.default_rng(4).integers(1, 250, 90))
    outs = []
    for chunk in (0, piece):
        te = port_engine(params, cache_dtype=torch.float32)
        sched = Scheduler(te, prefill_chunk=chunk)
        try:
            outs.append(list(sched.submit(prompt, SlotOptions(**GREEDY),
                                          max_tokens=8).tokens()))
            assert sched.n_prefill_pieces == (0 if not chunk
                                              else -(-90 // piece))
        finally:
            sched.shutdown()
    assert outs[0] == outs[1]
