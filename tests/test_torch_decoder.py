"""The port's decoder against the JAX decoder on the tiny preset.

Both sides compute on identical weights (``convert.params_from_numpy`` of
the JAX params tree: f32, int4 or int8 weights) with an int8 paged KV pool of the same layout: two
slots are prefilled (``prefill_chunk``) and inserted (``paged_insert``),
then 16 batched decode steps (``forward_with_cache_paged``) feed each
side's own greedy tokens back. The JAX side runs its Pallas kernels in
interpret mode; the port runs its kernels' plain versions (CPU, f32).
Tolerance: logits within 1e-4 (f32 sums reassociated, int8 KV codes of
the same values), greedy tokens identical.
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
from ollama_operator_tpu.ops import quant as jquant
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS

torch.set_num_threads(1)

JCFG = dataclasses.replace(JPRESETS["tiny"], kernels="interpret")
TCFG = TPRESETS["tiny"]
PS, P, NBLK = 16, 16, 8


def _pools_jax(cfg):
    shp = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.head_dim)
    return [{"q": jnp.zeros(shp, jnp.int8),
             "s": jnp.zeros(shp[:-1], jnp.float32)} for _ in range(2)]


def _pools_torch(cfg):
    shp = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.head_dim)
    return [{"q": torch.zeros(shp, dtype=torch.int8),
             "s": torch.zeros(shp[:-1])} for _ in range(2)]


@pytest.mark.parametrize("bits", [None, 4, 8])
def test_decoder_paged_matches_jax(bits):
    params = jdec.init_params(JCFG, jax.random.key(0), jnp.float32)
    pn = jax.tree_util.tree_map(np.asarray, params)
    if bits:
        pn = jquant.quantize_params(pn, bits=bits)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    tp = params_from_numpy(pn, device="cpu")
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, TCFG.vocab_size, n).astype(np.int32)
               for n in (13, 30)]
    tables = np.zeros((2, NBLK), np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :3] = [9, 1, 12]
    jk, jv = _pools_jax(JCFG)
    tk, tv = _pools_torch(TCFG)
    jprefill = jax.jit(functools.partial(jdec.prefill_chunk, cfg=JCFG))
    first = []
    for b, pr in enumerate(prompts):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(pr)] = pr
        jl, jks, jvs = jprefill(jp, tokens=jnp.asarray(toks))
        tl, tks, tvs = tdec.prefill_chunk(tp, TCFG, torch.tensor(toks).long())
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        jk, jv = jdec.paged_insert(JCFG, jk, jv, jks, jvs,
                                   jnp.asarray(tables[b]), len(pr))
        tdec.paged_insert(TCFG, tk, tv, tks, tvs, torch.tensor(tables[b]),
                          len(pr))
        first.append(int(np.argmax(np.asarray(jl)[0, len(pr) - 1])))
    np.testing.assert_array_equal(tk["q"].numpy(), np.asarray(jk["q"]))

    jstep = jax.jit(functools.partial(jdec.forward_with_cache_paged,
                                      cfg=JCFG, attn_blocks=4))
    lengths = np.array([len(p) for p in prompts], np.int32)
    jtok = ttok = np.array(first, np.int32)[:, None]
    for _ in range(16):
        jl, jk, jv = jstep(jp, tokens=jnp.asarray(jtok), k_pool=jk,
                           v_pool=jv, tables=jnp.asarray(tables),
                           lengths=jnp.asarray(lengths))
        tl, tk, tv = tdec.forward_with_cache_paged(
            tp, TCFG, torch.tensor(ttok).long(), tk, tv,
            torch.tensor(tables), torch.tensor(lengths), 4)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        jtok = np.asarray(jnp.argmax(jl[:, 0], axis=-1)).astype(
            np.int32)[:, None]
        ttok = tl[:, 0].argmax(dim=-1).numpy().astype(np.int32)[:, None]
        np.testing.assert_array_equal(ttok, jtok)
        lengths = lengths + 1


def test_init_params_layout_matches_jax():
    jp = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(JCFG, jax.random.key(0), jnp.float32))
    tp = tdec.init_params(TCFG,
                          torch.Generator(device="cpu").manual_seed(0),
                          torch.float32, "cpu")
    assert set(tp) == set(jp) and set(tp["layers"]) == set(jp["layers"])
    for k, v in jp["layers"].items():
        assert tuple(tp["layers"][k].shape) == v.shape, k
    w = tp["layers"]["w_up"].numpy()
    assert abs(w.std() - 0.02) < 2e-3 and abs(w.mean()) < 2e-3
    assert (tp["layers"]["attn_norm_w"] == 1).all()
