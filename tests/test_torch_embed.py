"""Decoder embeddings: the port's ``LoadedModel.embed`` against the JAX
package's, on the CPU, on identical weights (``params_from_numpy`` of the
JAX tree).

Four families of the tiny presets, each through its attention route:
a dense llama (GQA, the flash-prefill route), phi3's MHA with a window
shorter than the texts, gemma3 (alternating windows: the masked einsum),
and a qwen3moe (the experts' batched form at 256 rows and below, their
loop above). Seven texts of 4 to 77 byte tokens make four length
buckets (16, 32, 64, 128) of 3, 1, 2 and 1 texts, so batches pad to 4,
1, 2 and 1 rows. Both sides run in f32 (the JAX side's Pallas kernels in
interpret mode): every vector within 1e-4 relative and absolute (f32
sums reassociated), rows in input order, a text embedded alone equal to
its row in the batch.

One bf16 test holds the pooling's rounding to the JAX serving function:
with no layer, the JAX body is the embedding, the final norm and the
mean, and the port's must give its bits (XLA rounds the normed rows, the
masked sum and the count to bf16, so 257..512 valid rows count as an
even number, and divides in f32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.service import LoadedModel as JLoadedModel
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime.engine import EngineConfig
from ollama_operator_tpu_torch.runtime.service import LoadedModel
from ollama_operator_tpu_torch.tokenizer import Tokenizer
from test_torch_families import configs as family_configs
from test_torch_families import family_params
from test_torch_moe import configs as moe_configs
from test_torch_moe import moe_params

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
BYTES = dict(tokens=[f"<0x{i:02X}>" for i in range(256)],
             token_types=[6] * 256)   # byte-fallback pieces only
# byte tokens (a space is the three bytes of "▁"): 8, 24, 4, 62, 77, 4
# and 44 tokens, buckets 16, 32, 16, 64, 128, 16, 64
TEXTS = ["embed", "vector-search-over-docs", "x",
         "the quick brown fox jumps over the lazy dog",
         "retrieval augmented generation " * 2, "a",
         "bucketed by length, twice over"]


def _tiny(**kw):
    return (dataclasses.replace(JPRESETS["tiny"], kernels="interpret",
                                **kw).validate(),
            dataclasses.replace(TPRESETS["tiny"], **kw).validate())


def _dense_params(jc, seed):
    p = jax.tree_util.tree_map(np.asarray, jdec.init_params(
        jc, jax.random.key(seed), jnp.float32))
    return (jax.tree_util.tree_map(jnp.asarray, p),
            params_from_numpy(p, device="cpu"))


def family(name):
    """(JAX config, port config, JAX params, port params)."""
    if name == "llama":
        jc, tc = _tiny()
        return (jc, tc) + _dense_params(jc, 1)
    if name == "phi3":
        jc, tc = _tiny(n_kv_heads=4, sliding_window=12)
        return (jc, tc) + _dense_params(jc, 2)
    if name == "gemma3":
        return family_configs(name) + family_params(name)
    return moe_configs(name) + moe_params(name)


def models(name, monkeypatch):
    monkeypatch.setenv("TPU_WARM_BUCKETS", "0")
    jc, tc, jp, tp = family(name)
    kw = dict(paged=False, max_slots=2, max_seq_len=128,
              min_prefill_bucket=16, decode_chunk=4)
    jlm = JLoadedModel(name, jc, jp, JTokenizer(model="llama", **BYTES),
                       ecfg=JEngineConfig(cache_dtype=jnp.float32, **kw))
    lm = LoadedModel(name, tc, tp, Tokenizer(model="llama", **BYTES),
                     ecfg=EngineConfig(cache_dtype=torch.float32, **kw),
                     device="cpu")
    return jlm, lm


@pytest.mark.parametrize("name", ["llama", "phi3", "gemma3", "qwen3moe"])
def test_embed_matches_jax_loaded_model(name, monkeypatch):
    jlm, lm = models(name, monkeypatch)
    try:
        lens = [len(lm.tokenizer.encode(t)) for t in TEXTS]
        assert lens == [len(jlm.tokenizer.encode(t)) for t in TEXTS]
        assert sorted({max(16, 1 << (n - 1).bit_length()) for n in lens}
                      ) == [16, 32, 64, 128]
        want = jlm.embed(TEXTS)
        got = lm.embed(TEXTS)
        assert got.dtype == np.float32 and got.shape == (7, lm.cfg.dim)
        np.testing.assert_allclose(got, want, **TOL)
        alone = lm.embed([TEXTS[4]])
        np.testing.assert_allclose(alone[0], got[4], **TOL)
        assert np.isfinite(got).all() and np.abs(got).max() > 0
    finally:
        jlm.unload()
        lm.unload()


@pytest.mark.parametrize("n_layers", [0, 2])
def test_pooling_rounds_as_the_jax_serving_function(n_layers, monkeypatch):
    """bf16 on both sides. With no layer the outputs are bit-equal: the
    normed rows, the masked sum and the count rounded to bf16 (301 valid
    rows count as 300), the division in f32, where XLA rounds the JAX
    body. With two layers none differs by more than one bf16 ulp of the
    largest; about 40% differ within it, since XLA keeps f32 through the
    layers' elementwise steps (norms, residual adds, rope) where the
    port rounds each op's output."""
    monkeypatch.setenv("TPU_WARM_BUCKETS", "0")
    jc, tc = _tiny(max_seq_len=1024)
    p = jax.tree_util.tree_map(np.asarray, jdec.init_params(
        jc, jax.random.key(4), jnp.float32))
    p["out_norm_w"] = (1 + np.random.default_rng(2).normal(
        0, 0.2, p["out_norm_w"].shape)).astype(np.float32)
    p["layers"] = {k: v[:n_layers] for k, v in p["layers"].items()}
    jc = dataclasses.replace(jc, n_layers=n_layers, kernels="xla")
    tc = dataclasses.replace(tc, n_layers=n_layers)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    tp = jax.tree_util.tree_map(lambda t: t.to(torch.bfloat16),
                                params_from_numpy(p, "cpu"))
    jlm = JLoadedModel("r", jc, jp, JTokenizer(model="llama", **BYTES),
                       ecfg=JEngineConfig(paged=False, max_slots=1,
                                          max_seq_len=1024,
                                          cache_dtype=jnp.bfloat16,
                                          min_prefill_bucket=16))
    try:
        rng = np.random.default_rng(6)
        # 300 and 301 valid rows: bf16 counts 300 and 300 (301 rounds)
        texts = ["".join(chr(c) for c in rng.integers(97, 123, n))
                 for n in (297, 298, 148, 5)]
        want = jlm.embed(texts)
    finally:
        jlm.unload()
    lm = LoadedModel("r", tc, tp, Tokenizer(model="llama", **BYTES),
                     ecfg=EngineConfig(paged=False, max_slots=1,
                                       max_seq_len=1024,
                                       cache_dtype=torch.bfloat16,
                                       min_prefill_bucket=16), device="cpu")
    try:
        assert [len(lm.tokenizer.encode(t)) for t in texts] == [
            300, 301, 151, 8]
        got = lm.embed(texts)
    finally:
        lm.unload()
    if n_layers == 0:
        np.testing.assert_array_equal(got, want)
        return
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - 7)
    assert np.abs(got - want).max() <= ulp
