"""The port's decoder on the JAX package's other dense families, on the CPU.

Tiny configs with each family's flags (as ``tests/test_decoder.py`` builds
them): qwen3 (qk-norm), gemma2 (sandwich norms, softcaps, alternating
sliding/full layers with a window shorter than the prompts), gemma3
(pattern 6 over 6 layers, dual rope with a linear-scaled global theta,
qk-norm, sandwich norms), starcoder2 (LayerNorm with biases, plain gelu
MLP with biases, output bias, a group of 12 under a window) and phi2
(parallel block, partial rotary 0.4, biases everywhere). Norm weights and
biases are drawn at random, so every leaf moves the result.

- ``prefill_chunk``: logits and the K/V it returns;
- the dense slot cache (``forward_with_cache`` at T = 1 and an extend at
  T > 1), f32;
- the paged forward in ``tests/test_torch_families_paged.py``.

Both sides compute in f32 on identical weights (``params_from_numpy`` of
the JAX tree); the JAX side runs its Pallas kernels in interpret mode
wherever its route reaches them (flash prefill, the paged and dense
decode kernels; the alternating archs take its einsum everywhere, as the
port's do). Tolerance: logits within 1e-4 relative and absolute (f32 sums
reassociated, int8 KV codes of the same values), greedy tokens identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
GEMMA = dict(act="gelu_tanh", emb_scale=True, tie_embeddings=True,
             norm_weight_offset=1.0, post_norms=True, altern_sliding=True)
FAMILIES = {
    "qwen3": dict(qk_norm=True, rope_theta=1e6),
    "gemma2": dict(GEMMA, sliding_window=8, attn_softcap=50.0,
                   logit_softcap=30.0, head_dim=32, n_heads=4,
                   n_kv_heads=2),
    "gemma3": dict(GEMMA, n_layers=6, sliding_pattern=6, qk_norm=True,
                   sliding_window=8, rope_local_theta=10000.0,
                   rope_theta=1e6, rope_scaling_type="linear",
                   rope_scaling=8.0, attn_scale=16.0),
    "starcoder2": dict(norm_type="layernorm", mlp_type="plain",
                       act="gelu_tanh", attn_bias=True, out_bias=True,
                       tie_embeddings=True, n_heads=12, n_kv_heads=1,
                       sliding_window=16, rope_theta=999999.0),
    "phi2": dict(norm_type="layernorm", mlp_type="plain", act="gelu_tanh",
                 parallel_block=True, attn_bias=True, out_bias=True,
                 rotary_pct=0.4, n_kv_heads=4),
}
NAMES = sorted(FAMILIES)


def configs(name: str):
    """(the JAX config with its kernels in interpret mode, the port's)."""
    kw = FAMILIES[name]
    jc = dataclasses.replace(JPRESETS["tiny"], kernels="interpret", **kw)
    tc = dataclasses.replace(TPRESETS["tiny"], **kw)
    return jc.validate(), tc.validate()


def is_small_leaf(name: str) -> bool:
    """Norm weights and biases: init_params makes them ones and zeros."""
    return name.endswith(("norm_w", "norm_b")) or name in (
        "bq", "bk", "bv", "bo", "b_up", "b_down", "lm_head_b")


def random_small_leaves(tree, rng):
    """The numpy params tree with every norm weight and bias drawn at
    random around its init value, so that each one moves the output."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = random_small_leaves(v, rng)
        elif is_small_leaf(k):
            out[k] = (v + rng.normal(0.0, 0.2, v.shape)).astype(v.dtype)
        else:
            out[k] = v
    return out


@functools.lru_cache(maxsize=None)
def jax_fns(name: str):
    """The JAX functions of the family's config, jitted (one compile per
    shape; eager interpret-mode kernels run op by op)."""
    jc, _ = configs(name)
    return dict(
        prefill=jax.jit(functools.partial(jdec.prefill_chunk, cfg=jc)),
        insert=jax.jit(functools.partial(jdec.paged_insert, jc)),
        paged=jax.jit(functools.partial(jdec.forward_with_cache_paged,
                                        cfg=jc),
                      static_argnames=("attn_blocks",)),
        dense=jax.jit(functools.partial(jdec.forward_with_cache, cfg=jc),
                      static_argnames=("attn_len",)))


@functools.lru_cache(maxsize=None)
def family_params(name: str):
    """(JAX params, the port's params) of the family's tiny config, f32."""
    jc, _ = configs(name)
    p = jax.tree_util.tree_map(np.asarray, jdec.init_params(
        jc, jax.random.key(NAMES.index(name)), jnp.float32))
    p = random_small_leaves(p, np.random.default_rng(11))
    return (jax.tree_util.tree_map(jnp.asarray, p),
            params_from_numpy(p, device="cpu"))


def prompts(rng, vocab):
    """Two prompts, both longer than the gemma windows (8)."""
    return [rng.integers(0, vocab, n).astype(np.int32) for n in (13, 30)]


def assert_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


@pytest.mark.parametrize("name", NAMES)
def test_prefill_matches_jax(name):
    jc, tc = configs(name)
    jp, tp = family_params(name)
    toks = np.random.default_rng(1).integers(0, tc.vocab_size, (2, 24))
    jl, jks, jvs = jax_fns(name)["prefill"](
        jp, tokens=jnp.asarray(toks, jnp.int32))
    tl, tks, tvs = tdec.prefill_chunk(tp, tc, torch.tensor(toks).long())
    assert_close(tl, jl)
    assert_close(tks, jks)
    assert_close(tvs, jvs)


@pytest.mark.parametrize("name", NAMES)
def test_dense_decode_and_extend_match_jax(name):
    """Two slots of a 48-row f32 slot cache: prefills inserted, 4 batched
    decode steps at T = 1 over a 40-row attended prefix, then slot 1 alone
    extends 7 tokens at T > 1 over a view of its rows."""
    jc, tc = configs(name)
    jp, tp = family_params(name)
    rng = np.random.default_rng(5)
    pr = prompts(rng, tc.vocab_size)
    S = 48
    shp = (tc.n_layers, 2, tc.n_kv_heads, S, tc.head_dim)
    jk, jv = jnp.zeros(shp, jnp.float32), jnp.zeros(shp, jnp.float32)
    tk, tv = torch.zeros(shp), torch.zeros(shp)
    toks = np.zeros((2, 32), np.int32)
    for b, p in enumerate(pr):
        toks[b, :len(p)] = p
    J = jax_fns(name)
    jl, jks, jvs = J["prefill"](jp, tokens=jnp.asarray(toks))
    tl, tks, tvs = tdec.prefill_chunk(tp, tc, torch.tensor(toks).long())
    assert_close(tl, jl)
    jk, jv = jk.at[:, :, :, :32].set(jks), jv.at[:, :, :, :32].set(jvs)
    tk[:, :, :, :32], tv[:, :, :, :32] = tks, tvs
    lengths = np.array([len(p) for p in pr], np.int32)
    tok = np.array([np.argmax(np.asarray(jl)[b, n - 1])
                    for b, n in enumerate(lengths)], np.int32)[:, None]
    for _ in range(4):
        jl, jk, jv = J["dense"](
            jp, tokens=jnp.asarray(tok), k_cache=jk, v_cache=jv,
            lengths=jnp.asarray(lengths), attn_len=40)
        tl, tk, tv = tdec.forward_with_cache(
            tp, tc, torch.tensor(tok).long(), tk, tv,
            torch.tensor(lengths), attn_len=40)
        assert_close(tl, jl)
        tok = np.asarray(jnp.argmax(jl[:, 0], axis=-1)).astype(
            np.int32)[:, None]
        np.testing.assert_array_equal(
            tl[:, 0].argmax(dim=-1).numpy(), tok[:, 0])
        lengths = lengths + 1
    tail = rng.integers(0, tc.vocab_size, (1, 7)).astype(np.int32)
    start = int(lengths[1])
    jl, _, _ = J["dense"](
        jp, tokens=jnp.asarray(tail), k_cache=jk[:, 1:], v_cache=jv[:, 1:],
        lengths=jnp.asarray([start], jnp.int32))
    tl, _, _ = tdec.forward_with_cache(
        tp, tc, torch.tensor(tail).long(), tk[:, 1:].clone(),
        tv[:, 1:].clone(), torch.tensor([start], dtype=torch.int32))
    assert_close(tl, jl)
