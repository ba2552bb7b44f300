"""The port's engine and scheduler on the gemma3- and starcoder2-style
configs of ``tests/test_torch_families.py``, against the JAX package's.

Both serve the same f32 weights on an int8 paged pool (page size 8,
pieces of 16 tokens), greedy: first a 40-token prompt (five times the
gemma3 window and 2.5 times the starcoder2 one, admitted in three pieces
with a decode dispatch between each two) beside two short prompts, then,
once that prompt's pages were donated to the radix tree, a prompt that
shares its first 36 tokens (stitched: four full pages and a copied
boundary page). Every stream must equal the JAX scheduler's, and the
stitched request must reuse a prefix on both sides.
"""

import threading

import numpy as np
import pytest
import torch

from ollama_operator_tpu.runtime.engine import Engine as JEngine
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import SlotOptions as JSlotOptions
from ollama_operator_tpu.runtime.scheduler import Scheduler as JScheduler
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)
from ollama_operator_tpu_torch.runtime.paged import live_tables
from ollama_operator_tpu_torch.runtime.scheduler import Scheduler
from test_torch_families import configs, family_params

torch.set_num_threads(1)

COMMON = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
              paged=True, page_size=8, decode_chunk=4)


def run(sched, opts, vocab):
    """The long prompt beside two short ones, then the stitched prompt.
    Returns (the four streams, the stitched request's reused tokens)."""
    rng = np.random.default_rng(21)
    long_ = [int(x) for x in rng.integers(1, vocab, 40)]
    short = [[int(x) for x in rng.integers(1, vocab, n)] for n in (6, 11)]
    reqs = [sched.submit(p, opts, max_tokens=n)
            for p, n in ((long_, 8), (short[0], 12), (short[1], 12))]
    streams = [[] for _ in reqs]

    def read(i, req):
        for chunk in req.chunks():
            streams[i].extend(chunk)

    ts = [threading.Thread(target=read, args=(i, r))
          for i, r in enumerate(reqs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts)
    stitched = long_[:36] + [int(x) for x in rng.integers(1, vocab, 5)]
    req = sched.submit(stitched, opts, max_tokens=8)
    streams.append(list(req.tokens()))
    return streams, req.stats.n_reused


@pytest.mark.parametrize("name", ["gemma3", "starcoder2"])
def test_greedy_streams_match_jax_engine(name):
    jc, tc = configs(name)
    jp, tp = family_params(name)
    je = JEngine(jc, jp, ecfg=JEngineConfig(cache_dtype=np.int8, **COMMON))
    jsched = JScheduler(je, prefill_chunk=16)
    try:
        want, j_reused = run(jsched, JSlotOptions(temperature=0.0),
                             tc.vocab_size)
    finally:
        jsched.shutdown()
    te = Engine(tc, tp, EngineConfig(cache_dtype=torch.int8, **COMMON),
                device="cpu")
    sched = Scheduler(te, prefill_chunk=16)
    try:
        got, reused = run(sched, SlotOptions(temperature=0.0),
                          tc.vocab_size)
        assert sched.n_prefill_pieces >= 3
    finally:
        sched.shutdown()
    assert [len(s) for s in got] == [8, 12, 12, 8]
    assert got == want
    assert reused == j_reused and reused >= 32
    for pt in live_tables():
        pt.check()
