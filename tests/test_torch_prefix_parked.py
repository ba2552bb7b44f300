"""The port's prefix reuse without the radix tree, against the JAX package.

- ``Engine.extend`` on the dense bf16 and int8 caches against the JAX
  ``Engine.extend`` (the paged pools' cases are in test_torch_prefix.py,
  with the shared helper);
- parked-slot reuse through the scheduler: on the dense cache (where the
  radix tree never runs) and on the paged pool under
  ``TPU_PREFIX_CACHE=0``, a finished request parks its slot and a
  conversation continuation extends it; the reuse and both streams equal
  the JAX scheduler's on the same requests.
"""

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
from test_torch_prefix import (JCFG, PEN, PS, TCFG, _port_page_accounting,
                               extend_against_jax, params)

torch.set_num_threads(1)

__all__ = ["_port_page_accounting", "params"]


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_dense_extend_matches_jax_engine(params, kind):
    extend_against_jax(params, kind, paged=False)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_parked_slot_streams_match_jax(params, paged, monkeypatch):
    """A 24-token prompt decodes 6 tokens and parks; the continuation
    (prompt, output and a new turn) extends the parked slot, reusing all
    but the last generated token, on both schedulers with the same
    streams."""
    monkeypatch.setenv("TPU_PREFIX_CACHE", "0")
    common = dict(max_slots=2, max_seq_len=128, min_prefill_bucket=16,
                  paged=paged, page_size=PS, repeat_last_n=8)
    je = JEngine(JCFG, params[0], ecfg=JEngineConfig(
        cache_dtype=np.float32, **common))
    te = Engine(TCFG, params[1], EngineConfig(
        cache_dtype=torch.float32, decode_chunk=8, **common), device="cpu")
    assert not je.radix_enabled and not te.radix_enabled
    p1 = list(np.random.default_rng(0).integers(1, 250, 24))
    out = {}
    for name, sched, opts in (
            ("jax", JScheduler(je), JSlotOptions(**PEN)),
            ("port", Scheduler(te), SlotOptions(**PEN))):
        try:
            r1 = sched.submit(p1, opts, max_tokens=6)
            gen = list(r1.tokens())
            r2 = sched.submit(p1 + gen + [7, 13, 52], opts, max_tokens=6)
            out[name] = (gen, list(r2.tokens()), r1.stats.n_reused,
                         r2.stats.n_reused)
        finally:
            sched.shutdown()
    assert out["port"] == out["jax"]
    assert out["port"][3] == 24 + 6 - 1
    if paged:
        te._pt.check()
