"""Serving a sub-4B model the way the JAX package serves one: int8
weights, resolved and quantized by ``ModelManager.preload``, on an int8 or
an int4 paged KV pool, on the CPU at the tiny preset.

- greedy token streams of three concurrent requests equal the JAX
  package's ``LoadedModel`` on a tied-embedding config with a GQA group of
  G = 3 (the shape of llama3.2:3b), for both pools;
- ``preload`` resolves the weight dtype per device, lets an explicit one
  win, and refuses a tree that is already quantized.
"""

import dataclasses
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops import quant as jquant
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.service import LoadedModel as JLoadedModel
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime.engine import EngineConfig
from ollama_operator_tpu_torch.server.app import ModelManager
from ollama_operator_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

TPL = "{{ .Prompt }}"
PROMPTS = ["the quick brown fox", "paged attention", "x"]
GREEDY = {"temperature": 0, "num_predict": 12}
BYTES = dict(tokens=[f"<0x{i:02X}>" for i in range(256)],
             token_types=[6] * 256)   # byte-fallback pieces only


def _concurrent(lm, prompts, options):
    out = [None] * len(prompts)

    def run(i):
        out[i] = lm.generate(prompts[i], options)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(out))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return out


G3 = dict(n_heads=6, n_kv_heads=2, tie_embeddings=True)
ECFG = dict(paged=True, max_slots=4, max_seq_len=128, page_size=16,
            min_prefill_bucket=16, decode_chunk=8)


@pytest.mark.parametrize("kv", ["int8", "int4"])
def test_tied_g3_int8_weights_match_jax_loaded_model(kv, monkeypatch):
    """Dense f32 params of a tied G = 3 tiny config: the JAX model serves
    them quantized to int8 by its own ``quantize_params``; the port's
    ``ModelManager.preload`` quantizes them itself (``dtype="int8"``).
    Greedy streams of three concurrent requests are identical on an int8
    and on an int4 pool."""
    monkeypatch.setenv("TPU_WARM_BUCKETS", "0")
    jcfg = dataclasses.replace(JPRESETS["tiny"], **G3)
    dense = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jcfg, jax.random.key(5), jnp.float32))
    assert "lm_head" not in dense
    jlm = JLoadedModel(
        "tiny", jcfg, jax.tree_util.tree_map(
            jnp.asarray, jquant.quantize_params(
                jax.tree_util.tree_map(np.copy, dense), bits=8)),
        JTokenizer(model="llama", **BYTES), template=TPL,
        ecfg=JEngineConfig(cache_dtype=kv, **ECFG))
    try:
        ref = _concurrent(jlm, PROMPTS, GREEDY)
    finally:
        jlm.unload()
    mm = ModelManager(device="cpu")
    lm = mm.preload("tiny", dataclasses.replace(TPRESETS["tiny"], **G3),
                    params_from_numpy(dense, device="cpu"),
                    Tokenizer(model="llama", **BYTES), dtype="int8",
                    template=TPL, kv_dtype=kv,
                    ecfg=EngineConfig(cache_dtype=torch.float32, **ECFG))
    try:
        assert lm.serving_dtype == "int8"
        assert set(lm.engine.params["layers"]["wq"]) == {"q", "s"}
        assert set(lm.engine.k_cache) == ({"q4", "s"} if kv == "int4"
                                          else {"q", "s"})
        got = _concurrent(lm, PROMPTS, GREEDY)
    finally:
        mm.shutdown()
    for r, g in zip(ref, got):
        assert g.context == r.context
        assert g.generated_tokens == r.generated_tokens == 12


@pytest.fixture(scope="module")
def numpy_params():
    p = jdec.init_params(JPRESETS["tiny"], jax.random.key(3), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def test_preload_resolves_weight_dtype(numpy_params):
    """With no dtype the CPU serves f32 (the JAX loader's CPU choice); an
    explicit dtype wins; a tree that is already quantized is refused."""
    mm = ModelManager(device="cpu")
    try:
        lm = mm.preload("tiny", TPRESETS["tiny"],
                        params_from_numpy(numpy_params, device="cpu"),
                        Tokenizer(model="llama", **BYTES), template=TPL,
                        ecfg=EngineConfig(**ECFG))
        assert lm.serving_dtype == "float32"
        assert lm.engine.params["layers"]["wq"].dtype == torch.float32
        lm = mm.preload("tiny4", TPRESETS["tiny"],
                        params_from_numpy(numpy_params, device="cpu"),
                        Tokenizer(model="llama", **BYTES), dtype="int4",
                        template=TPL, ecfg=EngineConfig(**ECFG))
        assert set(lm.engine.params["layers"]["w_up"]) == {"q4", "s"}
        assert lm.engine.params["lm_head"]["q4"].dtype == torch.uint8
        assert [m["details"]["quantization_level"]
                for m in mm.list_models()] == ["float32", "int4"]
        with pytest.raises(ValueError, match="already quantized"):
            mm.preload("q", TPRESETS["tiny"], lm.engine.params,
                       Tokenizer(model="llama", **BYTES))
    finally:
        mm.shutdown()
