"""The port's prefix-cache extend against the JAX package, on the CPU.

- ``forward_with_cache_paged`` and ``forward_with_cache`` at T > 1 (an
  extend tail over a prior cache) on identical inputs: logits and the
  written pools agree with the JAX functions' on paged int8, int4 and f32
  pools and on dense f32 and int8 caches, an int4 tail at an odd offset
  included, where the tail's first code shares a byte with the prefix's
  last code and that nibble must survive;
- ``attend_hf_q4`` against the JAX ``attend_hf_q4`` at T > 1 with a
  causal window mask;
- ``Engine.extend`` after a parked admission against the JAX
  ``Engine.extend`` on paged int8, int4 and bf16 pools: the same first
  token (greedy, penalties on) and the same slot state (length, penalty
  ring and counts), and then the same decode tokens from the port.

Tiny preset, f32 activations (``kernels="xla"`` on the JAX side: its
plain reference path), page size 8, inputs from a numpy seed.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops import quant_cache as JQC
from ollama_operator_tpu.runtime.engine import Engine as JEngine
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import SlotOptions as JSlotOptions
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models import decoder
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.ops import quant_cache as QC
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)
from ollama_operator_tpu_torch.runtime.paged import live_tables

torch.set_num_threads(1)

JCFG = dataclasses.replace(JPRESETS["tiny"], kernels="xla")
TCFG = TPRESETS["tiny"]
L, KvH, HD, PS = JCFG.n_layers, JCFG.n_kv_heads, JCFG.head_dim, 8
TOL = dict(rtol=1e-4, atol=1e-4)
PEN = dict(temperature=0.0, repeat_penalty=1.3, presence_penalty=0.2,
           repeat_last_n=8)


@pytest.fixture(autouse=True)
def _port_page_accounting():
    yield
    for pt in live_tables():
        pt.check()


@pytest.fixture(scope="module")
def params():
    p = jdec.init_params(JCFG, jax.random.key(5), jnp.float32)
    npp = jax.tree_util.tree_map(np.asarray, p)
    return p, params_from_numpy(npp, device="cpu")


def _pool(rng, kind, P):
    """Random K or V storage of one kind, as numpy: (JAX tree, port
    tree)."""
    if kind == "int8":
        q = rng.integers(-127, 128, (L, P, KvH, PS, HD)).astype(np.int8)
        s = (rng.random((L, P, KvH, PS)) * 0.02).astype(np.float32)
        return ({"q": q, "s": s}, {"q": q, "s": s})
    if kind == "int4":
        q4 = rng.integers(0, 256, (L, P, KvH, PS // 2, HD)).astype(np.uint8)
        s = (rng.random((L, P, KvH, PS)) * 0.2).astype(np.float32)
        return ({"q4": q4.view(np.int8), "s": s}, {"q4": q4, "s": s})
    x = rng.standard_normal((L, P, KvH, PS, HD)).astype(np.float32)
    return x, x


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: torch.from_numpy(v.copy()) for k, v in tree.items()}
    return torch.from_numpy(tree.copy())


def _np(tree):
    if isinstance(tree, dict):
        return {k: (v.numpy() if isinstance(v, torch.Tensor)
                    else np.asarray(v)).view(np.uint8 if k == "q4"
                                             else np.asarray(v).dtype)
                for k, v in tree.items()}
    return tree.numpy() if isinstance(tree, torch.Tensor) else \
        np.asarray(tree)


@pytest.mark.parametrize("kind,start", [("int8", 13), ("int4", 13),
                                        ("int4", 16), ("f32", 13)])
def test_paged_tail_matches_jax(params, kind, start):
    """A 16-token tail at ``start`` over a 9-page pool (pages in a random
    order, the table's tail past the live pages on the trash page): the
    same logits and the same pools as the JAX paged forward; on the int4
    pool at an odd start the prefix's last code (the low nibble of the
    tail's first byte) is unchanged."""
    jp, tp = params
    rng = np.random.default_rng(start)
    P, T, nblk = 9, 16, 4
    (jk, tk), (jv, tv) = _pool(rng, kind, P), _pool(rng, kind, P)
    table = np.zeros((1, 8), np.int32)
    table[0, :4] = rng.permutation(np.arange(1, P))[:4]
    toks = rng.integers(0, JCFG.vocab_size, (1, T))
    jl, jk2, jv2 = jdec.forward_with_cache_paged(
        jp, JCFG, jnp.asarray(toks, jnp.int32), _to_jax(jk), _to_jax(jv),
        jnp.asarray(table), jnp.asarray([start], jnp.int32), nblk)
    tk_t, tv_t = _to_torch(tk), _to_torch(tv)
    tl, tk2, tv2 = decoder.forward_with_cache_paged(
        tp, TCFG, torch.from_numpy(toks), tk_t, tv_t,
        torch.from_numpy(table), torch.tensor([start], dtype=torch.int32),
        nblk)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    # every data page as the JAX forward leaves it (the trash page, page
    # 0, takes the port's discarded nibble writes, which the JAX package
    # drops instead)
    for j, t in ((jk2, tk2), (jv2, tv2)):
        jn, tn = _np(j), _np(t)
        if isinstance(jn, dict):
            key = "q4" if "q4" in jn else "q"
            np.testing.assert_array_equal(tn[key][:, 1:], jn[key][:, 1:])
            np.testing.assert_allclose(tn["s"][:, 1:], jn["s"][:, 1:], **TOL)
        else:
            np.testing.assert_allclose(tn[:, 1:], jn[:, 1:], **TOL)
    if kind == "int4" and start % 2:
        pg, row = table[0, start // PS], (start % PS) // 2
        before = tk["q4"][:, pg, :, row] & 0xF
        after = tk2["q4"][:, pg, :, row].numpy() & 0xF
        np.testing.assert_array_equal(after, before)


@pytest.mark.parametrize("kind", ["f32", "int8"])
def test_dense_tail_matches_jax(params, kind):
    """A 16-token tail at position 13 over one slot's dense rows,
    attending the first 32: the same logits and caches as the JAX
    forward."""
    jp, tp = params
    rng = np.random.default_rng(7)
    S, T, start, A = 64, 16, 13, 32
    if kind == "int8":
        def cache():
            return {"q": rng.integers(-127, 128, (L, 1, KvH, S, HD)
                                      ).astype(np.int8),
                    "s": (rng.random((L, 1, KvH, S)) * 0.02
                          ).astype(np.float32)}
    else:
        def cache():
            return rng.standard_normal((L, 1, KvH, S, HD)).astype(np.float32)
    kc, vc = cache(), cache()
    toks = rng.integers(0, JCFG.vocab_size, (1, T))
    jl, jk2, _ = jdec.forward_with_cache(
        jp, JCFG, jnp.asarray(toks, jnp.int32), _to_jax(kc), _to_jax(vc),
        jnp.asarray([start], jnp.int32), attn_len=A)
    tl, tk2, _ = decoder.forward_with_cache(
        tp, TCFG, torch.from_numpy(toks), _to_torch(kc), _to_torch(vc),
        torch.tensor([start], dtype=torch.int32), attn_len=A)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    jn, tn = _np(jk2), _np(tk2)
    if kind == "int8":
        np.testing.assert_array_equal(tn["q"], jn["q"])
        np.testing.assert_allclose(tn["s"], jn["s"], **TOL)
    else:
        np.testing.assert_allclose(tn, jn, **TOL)


def test_attend_hf_q4_matches_jax():
    rng = np.random.default_rng(3)
    B, T, H, S = 1, 5, 4, 24
    q = rng.standard_normal((B, T, H, HD)).astype(np.float32)

    def cache():
        return {"q4": rng.integers(0, 256, (B, KvH, S // 2, HD)
                                   ).astype(np.uint8),
                "s": (rng.random((B, KvH, S)) * 0.3).astype(np.float32)}
    kc, vc = cache(), cache()
    pos = 11 + np.arange(T)
    ok = np.arange(S)[None, :] <= pos[:, None]
    mask = np.where(ok, 0.0, -1e30).astype(np.float32)[None, None]
    want = JQC.attend_hf_q4(
        jnp.asarray(q), {"q4": jnp.asarray(kc["q4"].view(np.int8)),
                         "s": jnp.asarray(kc["s"])},
        {"q4": jnp.asarray(vc["q4"].view(np.int8)),
         "s": jnp.asarray(vc["s"])}, jnp.asarray(mask), 0.25)
    got = QC.attend_hf_q4(torch.from_numpy(q), _to_torch(kc), _to_torch(vc),
                          torch.from_numpy(mask), 0.25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


POOLS = {"int8": (jnp.int8, torch.int8), "int4": ("int4", "int4"),
         "bf16": (jnp.bfloat16, torch.bfloat16),
         "f32": (jnp.float32, torch.float32)}


def port_engine(params, kind, paged, slots=2):
    return Engine(TCFG, params[1], EngineConfig(
        cache_dtype=POOLS[kind][1], decode_chunk=1, max_slots=slots,
        max_seq_len=64, min_prefill_bucket=16, paged=paged, page_size=PS,
        repeat_last_n=8), device="cpu")


def jax_engine(params, kind, paged, slots=2):
    return JEngine(JCFG, params[0], ecfg=JEngineConfig(
        cache_dtype=POOLS[kind][0], max_slots=slots, max_seq_len=64,
        min_prefill_bucket=16, paged=paged, page_size=PS, repeat_last_n=8))


def decode(eng, slot, n):
    """``n`` single-step dispatches; the slot's tokens."""
    out = []
    for _ in range(n):
        h = eng.decode_n_launch(1)
        out.append(int(h.wait()[0, slot]))
        eng.retire(h.epoch)
    return out


def extend_against_jax(params, kind, paged):
    """Admit a 21-token prefix, park it, extend to 39 tokens from 21 (an
    odd offset: on the int4 pool the tail's first code shares a byte with
    the prefix's last) on both engines; the first tokens and slot state
    must agree, and the port's extended slot must go on decoding what a
    cold admission of the whole prompt decodes. Returns the port
    engine."""
    je, te = jax_engine(params, kind, paged), port_engine(params, kind, paged)
    rng = np.random.default_rng(11)
    full = rng.integers(1, JCFG.vocab_size, 39)
    for eng, opts in ((je, JSlotOptions(**PEN)), (te, SlotOptions(**PEN))):
        eng.admit(1, full[:21].astype(np.int32), opts)
        eng.release(1, park=True)
    jt = je.extend(1, full.astype(np.int32), 21, JSlotOptions(**PEN))
    tt = te.extend(1, full, 21, SlotOptions(**PEN))
    assert tt == jt
    assert int(te.lengths[1]) == int(np.asarray(je.lengths)[1]) == 39
    np.testing.assert_array_equal(te.pring[1].numpy(),
                                  np.asarray(je.pring)[1])
    np.testing.assert_array_equal(
        te.counts[1, :JCFG.vocab_size].numpy(), np.asarray(je.counts)[1])
    got = [tt] + decode(te, 1, 3)
    te.release(1)
    cold_eng = port_engine(params, kind, paged)
    cold = [cold_eng.admit(1, full, SlotOptions(**PEN))] + decode(
        cold_eng, 1, 3)
    assert got == cold
    return te


@pytest.mark.parametrize("kind", ["int8", "int4", "bf16"])
def test_paged_extend_matches_jax_engine(params, kind):
    te = extend_against_jax(params, kind, paged=True)
    te._pt.check()
    assert te._pt.n_free == te._pt.data_pages
