"""The block pieces the other dense families bring, in bf16 on the CPU,
against the JAX functions the serving path calls (f32 tests cannot see a
bf16 rounding fault, and the card's 1% and 3% checks cannot either).

- ``layer_norm`` with and without a bias (starcoder2, phi2; command-r);
- qk-norm inside ``_qkv`` (qwen3's plain weight, gemma3's w - 1), with
  partial rotary (phi2's 0.4);
- ``_residual`` with gemma2's sandwich norms, with phi2's parallel block
  and with starcoder2's LayerNorm MLP input;
- the plain MLP with its biases (``_mlp``) and the output projection's
  bias (``_proj_out``);
- the tanh gelu: the port's is one fused ``F.gelu`` that rounds once,
  where ``jax.nn.gelu`` rounds each of its steps on the CPU (about 40% of
  its bf16 outputs move). It is held within one bf16 ulp of the largest
  output of the JAX package's, and the blocks that hold it are compared
  with the JAX ones with their gelu taken in f32 and rounded once;
- ``_unembed`` with a LayerNorm's bias and ``lm_head_b`` (phi2);
- the paged-decode plain version at starcoder2's group (12 query heads a
  kv head) against the Pallas kernels in interpret mode, on bf16, int8
  and int4 pools.

Dense bf16 weights on both sides. The rule of ``tests/test_torch_dense.py``
holds the outputs: at most 2% of them may differ, none by more than one
bf16 ulp of the largest.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops import norms as jnorms
from ollama_operator_tpu.ops.pallas import paged as jpaged
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.ops import norms as tnorms
from ollama_operator_tpu_torch.ops import paged as tpaged
from test_torch_families import FAMILIES
from test_torch_rounding import (LENGTHS, NBLK, assert_bf16_matches,
                                 bf16_pair, paged_bf16_inputs)

torch.set_num_threads(1)


def cfgs(name):
    kw = FAMILIES[name]
    return (dataclasses.replace(JPRESETS["tiny"], kernels="xla",
                                **kw).validate(),
            dataclasses.replace(TPRESETS["tiny"], **kw).validate())


@pytest.fixture
def jax_gelu_rounded_once(monkeypatch):
    """The JAX package's ``_act`` with its tanh gelu taken in f32 and
    rounded once to the input's dtype, as the port's fused gelu rounds."""
    act = jdec._act

    def once(cfg, x):
        if cfg.act != "gelu_tanh":
            return act(cfg, x)
        return jax.nn.gelu(x.astype(jnp.float32),
                           approximate=True).astype(x.dtype)
    monkeypatch.setattr(jdec, "_act", once)


def layer_leaves(rng, cfg):
    """One layer's leaves of ``cfg`` (no leading L axis) as bf16 (JAX,
    torch) pairs: matrices ~ N(0, 0.05), norm weights ~ 1 + N(0, 0.2)
    (gemma's offset ones ~ N(0, 0.2)), biases ~ N(0, 0.2)."""
    D, F, hd = cfg.dim, cfg.ffn_dim, cfg.head_dim
    shapes = {"wq": (D, cfg.q_dim), "wk": (D, cfg.kv_dim),
              "wv": (D, cfg.kv_dim), "wo": (cfg.q_dim, D),
              "w_up": (D, F), "w_down": (F, D), "attn_norm_w": (D,)}
    if cfg.mlp_type == "gated":
        shapes["w_gate"] = (D, F)
    if not cfg.parallel_block:
        shapes["mlp_norm_w"] = (D,)
    if cfg.norm_type == "layernorm":
        shapes.update(attn_norm_b=(D,), mlp_norm_b=(D,))
        if cfg.parallel_block:
            del shapes["mlp_norm_b"]
    if cfg.attn_bias:
        shapes.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,), bv=(cfg.kv_dim,))
    if cfg.out_bias:
        shapes.update(bo=(D,), b_up=(F,), b_down=(D,))
    if cfg.qk_norm:
        shapes.update(q_norm_w=(hd,), k_norm_w=(hd,))
    if cfg.post_norms:
        shapes.update(post_attn_norm_w=(D,), post_ffw_norm_w=(D,))
    j, t = {}, {}
    for k, shp in shapes.items():
        x = rng.standard_normal(shp)
        if len(shp) == 2:
            x = x * 0.05
        elif k.endswith("norm_w") and not cfg.norm_weight_offset:
            x = 1.0 + 0.2 * x
        else:
            x = 0.2 * x
        j[k], t[k] = bf16_pair(x)
    return j, t


@pytest.mark.parametrize("bias", [True, False])
def test_layer_norm_rounds_like_jax(bias):
    rng = np.random.default_rng(800 + bias)
    jx, tx = bf16_pair(rng.standard_normal((3, 5, 96)) * 4 + 1)
    jw, tw = bf16_pair(1 + 0.3 * rng.standard_normal(96))
    jb, tb = bf16_pair(0.3 * rng.standard_normal(96)) if bias else (None,
                                                                     None)
    t = tnorms.layer_norm(tx, tw, tb, 1e-5)
    assert t.dtype == torch.bfloat16
    assert_bf16_matches(t, jnorms.layer_norm(jx, jw, jb, 1e-5))


@pytest.mark.parametrize("name", ["qwen3", "gemma3", "phi2"])
def test_qkv_rounds_like_jax(name):
    """q, k, v of ``_qkv``: the projections, biases, qk-norm and rope
    (phi2: partial rotary, no qk-norm)."""
    jc, tc = cfgs(name)
    rng = np.random.default_rng(810 + len(name))
    jl, tl = layer_leaves(rng, tc)
    jh, th = bf16_pair(rng.standard_normal((2, 6, tc.dim)))
    pos = np.arange(12).reshape(2, 6) + 40
    ang = pos[..., None] * (1e-2 * np.arange(1, tc.rotary_dim // 2 + 1))
    cos, sin = np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)
    j = jdec._qkv(jc, jl, jh, jnp.asarray(cos), jnp.asarray(sin))
    t = tdec._qkv(tc, tl, th, torch.tensor(cos), torch.tensor(sin))
    for a, b in zip(t, j):
        assert a.dtype == torch.bfloat16
        assert_bf16_matches(a, b)


@pytest.mark.parametrize("name", ["gemma2", "phi2", "starcoder2"])
def test_residual_rounds_like_jax(name, jax_gelu_rounded_once):
    """The block after attention: ``_proj_out`` (with bo), then
    ``_residual`` (sandwich norms, a parallel block, a LayerNorm MLP
    input) with the MLP inside (gated gelu, or plain with biases)."""
    jc, tc = cfgs(name)
    rng = np.random.default_rng(820 + len(name))
    jl, tl = layer_leaves(rng, tc)
    jx, tx = bf16_pair(rng.standard_normal((2, 5, tc.dim)))
    jh, th = bf16_pair(rng.standard_normal((2, 5, tc.dim)))
    ja, ta = bf16_pair(rng.standard_normal((2, 5, tc.n_heads,
                                            tc.head_dim)))
    jo = jdec._proj_out(jc, jl, ja, 2, 5)
    to = tdec._proj_out(tc, tl, ta)
    assert_bf16_matches(to, jo)
    t = tdec._residual(tc, tl, tx, th, to)
    assert t.dtype == torch.bfloat16
    assert_bf16_matches(t, jdec._residual(jc, jl, jx, jh, jo))


def test_plain_mlp_rounds_like_jax(jax_gelu_rounded_once):
    jc, tc = cfgs("starcoder2")
    rng = np.random.default_rng(830)
    jl, tl = layer_leaves(rng, tc)
    jx, tx = bf16_pair(rng.standard_normal((3, 4, tc.dim)))
    assert_bf16_matches(tdec._mlp(tc, tl, tx), jdec._mlp(jc, jl, jx))


def test_tanh_gelu_within_an_ulp_of_jax():
    """bf16: each output within one bf16 ulp of the largest output of the
    JAX package's op-by-op gelu; f32: the same function."""
    jc, tc = cfgs("starcoder2")
    x = np.random.default_rng(860).standard_normal((4, 512)) * 3
    jx, tx = bf16_pair(x)
    t = tdec._act(tc, tx)
    assert t.dtype == torch.bfloat16
    j = np.asarray(jdec._act(jc, jx).astype(jnp.float32))
    np.testing.assert_allclose(t.float().numpy(), j, rtol=0,
                               atol=2 ** -7 * np.abs(j).max())
    x32 = x.astype(np.float32)
    np.testing.assert_allclose(tdec._act(tc, torch.tensor(x32)).numpy(),
                               np.asarray(jdec._act(jc, jnp.asarray(x32))),
                               rtol=1e-6, atol=1e-6)


def test_unembed_with_biases_rounds_like_jax():
    """phi2's head: LayerNorm with a bias, an untied LM head and its
    bias, f32 logits."""
    jc, tc = cfgs("phi2")
    rng = np.random.default_rng(840)
    V, D = tc.vocab_size, tc.dim
    jp, tp = {}, {}
    for k, x in (("out_norm_w", 1 + 0.2 * rng.standard_normal(D)),
                 ("out_norm_b", 0.2 * rng.standard_normal(D)),
                 ("lm_head", 0.05 * rng.standard_normal((D, V))),
                 ("lm_head_b", 0.5 * rng.standard_normal(V)),
                 ("tok_emb", 0.05 * rng.standard_normal((V, D)))):
        jp[k], tp[k] = bf16_pair(x)
    jx, tx = bf16_pair(rng.standard_normal((2, 3, D)))
    j = np.asarray(jdec._unembed(jc, jp, jx))
    t = tdec._unembed(tc, tp, tx)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("pool", ["bf16", "int8", "int4"])
def test_paged_plain_rounds_like_pallas_at_group_12(pool, monkeypatch):
    """starcoder2's group (24 query heads over 2 kv heads) through the
    default route (v3), with a 40-position window."""
    rng = np.random.default_rng(850 + len(pool))
    (jq, tq), (jk, tk), (jv, tv), tables = paged_bf16_inputs(
        rng, pool, kvh=2, h=24)
    monkeypatch.setenv("TPU_PAGED_V3", "1")
    monkeypatch.setenv("TPU_PAGED_V4", "0")
    j = jpaged.paged_decode_attention_v3(
        jq, jk, jv, jnp.int32(0), jnp.asarray(tables), jnp.asarray(LENGTHS),
        64 ** -0.5, 0.0, 40, nblk=NBLK, interpret=True)
    t = tpaged.paged_decode_attention(
        tq, tk, tv, 0, torch.tensor(tables), torch.tensor(LENGTHS),
        64 ** -0.5, 0.0, 40, nblk=NBLK)
    assert t.dtype == torch.bfloat16
    assert_bf16_matches(t, j)
