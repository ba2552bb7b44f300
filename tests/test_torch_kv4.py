"""The port's int4 KV pool against the JAX package's.

- the codecs (``quantize_kv4``, ``pack_kv4``, ``unpack_kv4``) give the
  same codes, scales and bytes (the JAX package stores the bytes as int8,
  the port as uint8);
- the pool writes: a prefill insert (``paged_insert``, a pair straddling
  ``n_valid`` included) and three decode-step scatters of the same K/V
  leave bit-identical bytes at every live position and bit-identical
  scales;
- the decoder over an int4 pool (tiny preset with G = 3, tied
  embeddings, int8 weights): a prefill and 8 greedy decode steps against
  the JAX decoder with its Pallas kernels in interpret mode, logits within
  1e-4 (f32 sums reassociated) and greedy tokens identical.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops import quant as jquant
from ollama_operator_tpu.ops import quant_cache as jqc
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.ops import quant_cache as tqc

torch.set_num_threads(1)

G3 = dict(n_heads=6, n_kv_heads=2, tie_embeddings=True)
JCFG = dataclasses.replace(JPRESETS["tiny"], kernels="interpret", **G3)
TCFG = dataclasses.replace(TPRESETS["tiny"], **G3)
PS, P, NBLK = 16, 16, 8


def test_kv4_codecs_bit_identical():
    rng = np.random.default_rng(70)
    x = rng.standard_normal((3, 2, 10, 16)).astype(np.float32)
    x[0, 0, 0] = 0.0                     # an all-zero vector: scale 0
    jq, js = jqc.quantize_kv4(jnp.asarray(x))
    tq, ts = tqc.quantize_kv4(torch.tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for axis in (-2, 2, 1):
        jp = np.asarray(jqc.pack_kv4(jq, axis=axis))
        tp = tqc.pack_kv4(tq, axis=axis)
        assert tp.dtype == torch.uint8
        np.testing.assert_array_equal(tp.numpy(), jp.view(np.uint8))
        np.testing.assert_array_equal(
            tqc.unpack_kv4(tp, axis=axis).numpy(),
            np.asarray(jqc.unpack_kv4(jnp.asarray(jp), axis=axis)))
    b = rng.integers(0, 256, (4, 6, 8)).astype(np.uint8)
    np.testing.assert_array_equal(
        tqc.unpack_kv4(torch.tensor(b)).numpy(),
        np.asarray(jqc.unpack_kv4(jnp.asarray(b.view(np.int8)))))
    assert tqc.pool_bits({"q4": tp, "s": ts}) == 4
    assert tqc.pool_bits({"q": tq, "s": ts}) == 8


def _int4_pools_jax(cfg):
    shp = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.head_dim)
    return [{"q4": jnp.zeros(shp[:3] + (PS // 2, shp[4]), jnp.int8),
             "s": jnp.zeros(shp[:-1], jnp.float32)} for _ in range(2)]


def _int4_pools_torch(cfg):
    shp = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.head_dim)
    return [{"q4": torch.zeros(shp[:3] + (PS // 2, shp[4]),
                               dtype=torch.uint8),
             "s": torch.zeros(shp[:-1])} for _ in range(2)]


def _live_bytes_equal(tpool, jpool, tables, lengths):
    """Codes (as nibbles) and scales at every position < lengths[b] of
    every slot's pages are identical."""
    tq = tqc.unpack_kv4(tpool["q4"]).numpy()
    jq = np.asarray(jqc.unpack_kv4(jpool["q4"]))
    ts, js = tpool["s"].numpy(), np.asarray(jpool["s"])
    for b, n in enumerate(lengths):
        for pos in range(n):
            pg, off = tables[b, pos // PS], pos % PS
            np.testing.assert_array_equal(tq[:, pg, :, off], jq[:, pg, :, off])
            np.testing.assert_array_equal(ts[:, pg, :, off], js[:, pg, :, off])


def test_int4_pool_writes_bit_identical():
    """Insert two prefills (n_valid 13 leaves the pair (12, 13) straddling
    its end) and scatter three decode steps of the same K/V on both
    sides; every live position's bytes and scales agree bit for bit."""
    rng = np.random.default_rng(80)
    L, KvH, hd = TCFG.n_layers, TCFG.n_kv_heads, TCFG.head_dim
    tables = np.zeros((2, NBLK), np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :3] = [9, 1, 12]
    jk, jv = _int4_pools_jax(TCFG)
    tk, tv = _int4_pools_torch(TCFG)
    lengths = np.array([13, 30])
    for b, n in enumerate(lengths):
        ks, vs = (rng.standard_normal((L, 1, KvH, 32, hd)).astype(np.float32)
                  for _ in range(2))
        jk, jv = jdec.paged_insert(JCFG, jk, jv, jnp.asarray(ks),
                                   jnp.asarray(vs), jnp.asarray(tables[b]), n)
        tdec.paged_insert(TCFG, tk, tv, torch.tensor(ks), torch.tensor(vs),
                          torch.tensor(tables[b]), n)
    _live_bytes_equal(tk, jk, tables, lengths)
    _live_bytes_equal(tv, jv, tables, lengths)
    # the pair (12, 13) straddles n_valid = 13: its whole byte (row 6 of
    # page 5) lands on the slot's page, position 13's scale on the trash
    np.testing.assert_array_equal(tk["q4"][:, 5, :, 6].numpy(),
                                  np.asarray(jk["q4"][:, 5, :, 6]).view(
                                      np.uint8))
    assert (tk["s"][:, 5, :, 13] == 0).all()
    for _ in range(3):
        pos = lengths[:, None]
        pg = tables[np.arange(2)[:, None], pos // PS].astype(np.int32)
        off = (pos % PS).astype(np.int32)
        for i in range(L):
            k, v = (rng.standard_normal((2, KvH, 1, hd)).astype(np.float32)
                    for _ in range(2))
            jk, jv = jdec._scatter_kv_pools(jk, jv, i, jnp.asarray(k),
                                            jnp.asarray(v), jnp.asarray(pg),
                                            jnp.asarray(off))
            tdec._scatter_kv_pools(tk, tv, i, torch.tensor(k),
                                   torch.tensor(v), torch.tensor(pg).long(),
                                   torch.tensor(off).long())
        lengths = lengths + 1
        _live_bytes_equal(tk, jk, tables, lengths)
        _live_bytes_equal(tv, jv, tables, lengths)


def test_decoder_int4_pool_matches_jax():
    params = jdec.init_params(JCFG, jax.random.key(1), jnp.float32)
    pn = jquant.quantize_params(jax.tree_util.tree_map(np.asarray, params),
                                bits=8)
    jp = jax.tree_util.tree_map(jnp.asarray, pn)
    tp = params_from_numpy(pn, device="cpu")
    assert "lm_head" not in tp
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, TCFG.vocab_size, n).astype(np.int32)
               for n in (13, 30)]
    tables = np.zeros((2, NBLK), np.int32)
    tables[0, :2] = [5, 2]
    tables[1, :3] = [9, 1, 12]
    jk, jv = _int4_pools_jax(JCFG)
    tk, tv = _int4_pools_torch(TCFG)
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
    jstep = jax.jit(functools.partial(jdec.forward_with_cache_paged,
                                      cfg=JCFG, attn_blocks=4))
    lengths = np.array([len(p) for p in prompts], np.int32)
    jtok = ttok = np.array(first, np.int32)[:, None]
    for _ in range(8):
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
