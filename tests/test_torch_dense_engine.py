"""The port's dense-cache engine against the JAX ``Engine(paged=False)``.

Both engines serve the same f32 weights of the tiny preset (or its MHA
variant) on a dense slot cache, greedy: the JAX engine with its Pallas
kernels in interpret mode, the port on the CPU with its kernels' plain
versions. Slot 0 is admitted with a prompt longer than the sliding window
and decodes a chunk alone (slot 1's rows are computed while it is
inactive); then slot 1 is admitted and both decode two more chunks. The
tokens of every active slot must be identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.runtime.engine import Engine as JEngine
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import SlotOptions as JSlotOptions
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)

torch.set_num_threads(1)

WINDOW = dict(sliding_window=8)
MHA = dict(n_heads=8, n_kv_heads=8, head_dim=24, sliding_window=8)
ECFG = dict(max_slots=2, max_seq_len=128, min_prefill_bucket=16,
            decode_chunk=8)


@pytest.mark.parametrize("model,kv", [
    ("gqa", "float32"), ("gqa", "int8"), ("mha_kernel", "float32")])
def test_dense_engine_greedy_streams_match_jax(model, kv, monkeypatch):
    over = WINDOW if model == "gqa" else MHA
    if model == "mha_kernel":
        monkeypatch.setenv("TPU_MHA_KERNEL", "1")
    jcfg = dataclasses.replace(JPRESETS["tiny"], kernels="interpret", **over)
    tcfg = dataclasses.replace(TPRESETS["tiny"], **over)
    numpy_params = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jcfg, jax.random.key(9), jnp.float32))
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, numpy_params),
                   ecfg=JEngineConfig(paged=False, cache_dtype=getattr(
                       jnp, kv), **ECFG))
    teng = Engine(tcfg, params_from_numpy(numpy_params, device="cpu"),
                  EngineConfig(paged=False, cache_dtype=getattr(torch, kv),
                               **ECFG), device="cpu")
    assert not teng.paged
    rng = np.random.default_rng(13)
    long_prompt, short_prompt = rng.integers(0, 256, 21), rng.integers(
        0, 256, 6)
    got = {}
    for name, eng, opts in (("jax", jeng, JSlotOptions(temperature=0)),
                            ("port", teng, SlotOptions(temperature=0))):
        toks = [eng.admit(0, long_prompt, opts)]
        out0 = np.asarray(eng.decode_n_launch(8).wait())
        toks.append(eng.admit(1, short_prompt, opts))
        out1 = np.concatenate([np.asarray(eng.decode_n_launch(8).wait())
                               for _ in range(2)])
        got[name] = (toks, out0[:, 0].tolist(), out1.tolist())
    assert got["port"] == got["jax"]
