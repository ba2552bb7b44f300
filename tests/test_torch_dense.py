"""The port's dense slot-cache path against the JAX package, on the CPU.

- the plain versions of the GQA and MHA decode kernels against the Pallas
  ``decode_attention`` / ``mha_decode_attention`` in interpret mode, to
  1e-5 x max |out| (f32; softmax sums taken in another order);
- ``forward_with_cache`` at T=1 against the JAX decoder on the tiny preset
  and a tiny MHA variant (hd 24, window 8), f32 and int8 dense caches,
  weights carried across by ``convert.params_from_numpy``: logits within
  1e-4 x max |logit|, the updated caches equal (int8 codes exactly, f32
  values to 1e-5 x max);
- ``cached_attention``'s routing, the paged/dense resolvers against a
  hand-written table, the build tag of the CUDA libraries, and one HTTP
  round trip of a dense ``LoadedModel``.

The engine's greedy streams against the JAX ``Engine(paged=False)`` are in
``tests/test_torch_dense_engine.py``.
"""

import dataclasses
import functools
import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops.pallas.flash import \
    decode_attention as jdecode
from ollama_operator_tpu.ops.pallas.flash import \
    mha_decode_attention as jmha_decode
from ollama_operator_tpu.ops.quant_cache import attend_hf_q as jattend_hf_q
from ollama_operator_tpu.ops.quant_cache import quantize_kv as jquantize_kv
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.ops import attention as tattn
from ollama_operator_tpu_torch.ops import cuda_build
from ollama_operator_tpu_torch.ops import quant_cache as tqc
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      resolve_cache_dtype,
                                                      resolve_paged_default,
                                                      resolve_serving_defaults)
from ollama_operator_tpu_torch.runtime.service import LoadedModel
from ollama_operator_tpu_torch.server.app import ModelManager, serve
from ollama_operator_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

MHA = dict(n_heads=8, n_kv_heads=8, head_dim=24, sliding_window=8)
BYTES = dict(tokens=[f"<0x{i:02X}>" for i in range(256)],
             token_types=[6] * 256)   # byte-fallback pieces only


def _t(a):
    return torch.tensor(np.array(a))


def _decode_inputs(rng, B, H, KvH, S, hd):
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, KvH, S, hd)).astype(np.float32)
    v = rng.standard_normal((B, KvH, S, hd)).astype(np.float32)
    # ragged positions: the first key only, mid-block, the last key
    q_pos = np.array([0, 5, 77, S - 1][:B], np.int32)
    return q, k, v, q_pos


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (24, 30.0)])
@pytest.mark.parametrize("H,KvH", [(4, 2), (6, 2), (4, 4)])
def test_decode_attention_plain_matches_pallas(H, KvH, window, softcap):
    rng = np.random.default_rng(100 + H * 10 + KvH + window)
    q, k, v, q_pos = _decode_inputs(rng, 4, H, KvH, 128, 32)
    scale = 32 ** -0.5
    j = jdecode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                jnp.asarray(q_pos), scale, softcap, window, interpret=True)
    assert j is not None
    t = tattn.decode_attention(_t(q), _t(k), _t(v), _t(q_pos), scale,
                               softcap, window)
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("window,softcap", [(0, 0.0), (24, 0.0), (24, 30.0)])
def test_mha_decode_attention_plain_matches_pallas(window, softcap):
    rng = np.random.default_rng(200 + window)
    q, k, v, q_pos = _decode_inputs(rng, 4, 8, 8, 128, 24)
    scale = 24 ** -0.5
    j = jmha_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    jnp.asarray(q_pos), scale, softcap, window,
                    interpret=True)
    assert j is not None
    t = tattn.mha_decode_attention(_t(q), _t(k), _t(v), _t(q_pos), scale,
                                   softcap, window)
    j = np.asarray(j)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


def _assert_bf16_matches(t, j):
    """bf16 outputs of two computations that round alike: at most 2% of
    them differ (by an f32 sum taken in another order landing across a
    bf16 rounding boundary), none by more than 2^-7 x max |out| (one bf16
    ulp of the largest output). Rounding p differently from the JAX side
    changes about a quarter of the outputs."""
    t = t.float().numpy()
    j = np.asarray(j.astype(jnp.float32))
    assert np.mean(t != j) <= 0.02, f"{np.mean(t != j):.1%} of outputs differ"
    np.testing.assert_allclose(t, j, rtol=0, atol=2 ** -7 * np.abs(j).max())


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("H,KvH,hd", [(6, 2, 32), (8, 8, 24)])
def test_decode_plain_rounds_like_pallas_in_bf16(H, KvH, hd, window):
    """bf16 q and cache: the GQA plain version rounds p to bf16 before the
    p . v product as the Pallas ``decode_attention`` does (its MXU dot);
    the MHA plain version keeps p in f32 as ``mha_decode_attention``
    does. f32 tests cannot see either rounding."""
    rng = np.random.default_rng(300 + H + window)
    q, k, v, q_pos = _decode_inputs(rng, 4, H, KvH, 128, hd)
    jq, jk, jv = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    tq, tk, tv = (_t(a).to(torch.bfloat16) for a in (q, k, v))
    scale = hd ** -0.5
    jfn, tfn = ((jmha_decode, tattn.mha_decode_attention) if H == KvH
                else (jdecode, tattn.decode_attention))
    j = jfn(jq, jk, jv, jnp.asarray(q_pos), scale, 0.0, window,
            interpret=True)
    assert j is not None
    t = tfn(tq, tk, tv, _t(q_pos), scale, 0.0, window)
    assert t.dtype == torch.bfloat16
    _assert_bf16_matches(t, j)


@pytest.mark.parametrize("G", [1, 3])
def test_attend_hf_q_rounds_like_jax_in_bf16(G):
    """bf16 q against an int8 cache: p . v_scale is rounded to q's dtype
    before the p . v product, as the JAX ``attend_hf_q`` does."""
    rng = np.random.default_rng(400 + G)
    B, KvH, S, hd = 2, 2, 64, 32
    q = rng.standard_normal((B, 1, KvH * G, hd)).astype(np.float32)
    kc, vc = ({"q": c, "s": s} for c, s in (
        jquantize_kv(jnp.asarray(rng.standard_normal((B, KvH, S, hd)),
                                 jnp.float32)) for _ in range(2)))
    mask = np.where(np.arange(S) <= np.array([10, S - 1])[:, None], 0.0,
                    -1e30).astype(np.float32)[:, None, None, :]
    j = jattend_hf_q(jnp.asarray(q).astype(jnp.bfloat16), kc, vc,
                     jnp.asarray(mask), hd ** -0.5)
    t = tqc.attend_hf_q(_t(q).to(torch.bfloat16),
                        {n: _t(a) for n, a in kc.items()},
                        {n: _t(a) for n, a in vc.items()}, _t(mask),
                        hd ** -0.5)
    assert t.dtype == torch.bfloat16
    _assert_bf16_matches(t, j)


def test_decode_plain_rows_without_live_keys_are_zero():
    """A window that starts past the cache's last row (a slot decoding past
    its context) leaves no live key: the output is 0 (acc / max(l,
    1e-30)), not NaN, as in the Pallas kernel."""
    q = torch.ones((1, 1, 4, 8))
    k = v = torch.ones((1, 2, 16, 8))
    q_pos = torch.tensor([40], dtype=torch.int32)
    out = tattn.decode_attention(q, k, v, q_pos, 1.0, 0.0, 8)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("window", [0, 24, 2047])
def test_decode_chunks_cover_every_live_row_once(window):
    """The GQA decode kernel's sequence split at S = 4096: for every query
    position 0..S-1 its chunks (a count that depends on S alone) hold the
    live rows [max(0, q_pos - window + 1), q_pos] each exactly once, in
    chunk order, and a chunk past q_pos or before the window holds
    none."""
    S, chunk = 4096, tattn.DECODE_CHUNK
    assert chunk % 32 == 0
    for qp in range(S):
        rows = tattn.decode_chunk_rows(qp, S, window, chunk)
        assert len(rows) == -(-S // chunk)
        lo = max(0, qp - window + 1) if window else 0
        live = [r for r in rows if len(r)]
        assert live[0].start == lo and live[-1].stop == qp + 1
        assert all(a.stop == b.start for a, b in zip(live, live[1:]))
        for z, r in enumerate(rows):
            assert z * chunk <= r.start and r.stop <= (z + 1) * chunk \
                or not len(r)
            if z * chunk > qp or (z + 1) * chunk <= lo:
                assert not len(r)


@pytest.mark.parametrize("mha", [False, True])
@pytest.mark.parametrize("chunk", [0, -256, 48])
def test_decode_kernels_refuse_a_chunk_off_their_tile(chunk, mha,
                                                      monkeypatch):
    """On the card both dense decode wrappers split the rows in chunks of
    ``DECODE_CHUNK``, a positive multiple of the kernels' 32-row tile, and
    raise on any other chunk before they build, allocate or launch
    anything."""
    monkeypatch.setattr(cuda_build, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_build, "function", None)
    monkeypatch.setattr(tattn, "DECODE_CHUNK", chunk)
    H = 4 if mha else 8
    q = torch.zeros((2, 1, H, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 4, 128, 64), dtype=torch.bfloat16)
    q_pos = torch.tensor([3, 90], dtype=torch.int32)
    fn = tattn.mha_decode_attention if mha else tattn.decode_attention
    with pytest.raises(ValueError, match="chunks of a positive multiple"):
        fn(q, k, k, q_pos, 0.125)


def _jax_dense_insert(cache, ks, slot, quant):
    dus = jax.lax.dynamic_update_slice
    if quant:
        codes, scales = jquantize_kv(ks)
        return {"q": dus(cache["q"], codes, (0, slot, 0, 0, 0)),
                "s": dus(cache["s"], scales, (0, slot, 0, 0))}
    return dus(cache, ks.astype(cache.dtype), (0, slot, 0, 0, 0))


def _assert_caches_equal(t, j):
    if isinstance(j, dict):
        np.testing.assert_array_equal(t["q"].numpy(), np.asarray(j["q"]))
        js = np.asarray(j["s"])
        np.testing.assert_allclose(t["s"].numpy(), js, rtol=0,
                                   atol=1e-5 * np.abs(js).max())
    else:
        j = np.asarray(j)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("model,kv", [
    ("gqa", "float32"), ("gqa", "int8"), ("mha", "float32"),
    ("mha", "int8"), ("mha_kernel", "float32")])
def test_forward_with_cache_matches_jax(model, kv, monkeypatch):
    """Two slots prefilled at 32 tokens, then 12 batched decode steps
    (slot 1 starts at 30, so a window of 8 bites and it writes and attends
    past the prefill bucket), each side fed its own greedy tokens."""
    over = {} if model == "gqa" else MHA
    if model == "mha_kernel":
        monkeypatch.setenv("TPU_MHA_KERNEL", "1")
    jcfg = dataclasses.replace(JPRESETS["tiny"], kernels="interpret", **over)
    tcfg = dataclasses.replace(TPRESETS["tiny"], **over)
    jp = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jcfg, jax.random.key(7), jnp.float32))
    tp = params_from_numpy(jp, device="cpu")
    jp = jax.tree_util.tree_map(jnp.asarray, jp)
    quant = kv == "int8"
    L, B, S = jcfg.n_layers, 2, 64
    shp = (L, B, jcfg.n_kv_heads, S, jcfg.head_dim)
    if quant:
        jk, jv = ({"q": jnp.zeros(shp, jnp.int8),
                   "s": jnp.zeros(shp[:-1], jnp.float32)} for _ in range(2))
        tk, tv = ({"q": torch.zeros(shp, dtype=torch.int8),
                   "s": torch.zeros(shp[:-1])} for _ in range(2))
    else:
        jk = jv = jnp.zeros(shp, jnp.float32)
        tk, tv = torch.zeros(shp), torch.zeros(shp)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, 256, 9), rng.integers(0, 256, 30)]
    jprefill = jax.jit(functools.partial(jdec.prefill_chunk, cfg=jcfg))
    first = []
    for b, pr in enumerate(prompts):
        toks = np.zeros((1, 32), np.int32)
        toks[0, :len(pr)] = pr
        jl, jks, jvs = jprefill(jp, tokens=jnp.asarray(toks))
        _, tks, tvs = tdec.prefill_chunk(tp, tcfg, torch.tensor(toks).long())
        jk = _jax_dense_insert(jk, jks, b, quant)
        jv = _jax_dense_insert(jv, jvs, b, quant)
        tdec.dense_insert(tk, tv, tks, tvs, b)
        first.append(int(np.argmax(np.asarray(jl)[0, len(pr) - 1])))
    _assert_caches_equal(tk, jk)
    _assert_caches_equal(tv, jv)

    jstep = jax.jit(functools.partial(jdec.forward_with_cache, cfg=jcfg,
                                      attn_len=48))
    lengths = np.array([len(p) for p in prompts], np.int32)
    jtok = ttok = np.array(first, np.int32)[:, None]
    for _ in range(12):
        jl, jk, jv = jstep(jp, tokens=jnp.asarray(jtok), k_cache=jk,
                           v_cache=jv, lengths=jnp.asarray(lengths))
        tl, tk, tv = tdec.forward_with_cache(
            tp, tcfg, torch.tensor(ttok).long(), tk, tv,
            torch.tensor(lengths), attn_len=48)
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                                   atol=1e-4 * np.abs(jl).max())
        _assert_caches_equal(tk, jk)
        _assert_caches_equal(tv, jv)
        jtok = jl[:, 0].argmax(-1).astype(np.int32)[:, None]
        ttok = tl[:, 0].argmax(dim=-1).numpy().astype(np.int32)[:, None]
        np.testing.assert_array_equal(ttok, jtok)
        lengths = lengths + 1


def test_forward_with_cache_drops_writes_past_the_context():
    """A slot decoding past its context (lengths >= S) writes nothing and
    attends every row, as the JAX decoder (which drops out-of-bounds
    writes) does; the other slot's step is unchanged."""
    jcfg = dataclasses.replace(JPRESETS["tiny"], kernels="interpret")
    tcfg = TPRESETS["tiny"]
    jp = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jcfg, jax.random.key(8), jnp.float32))
    tp = params_from_numpy(jp, device="cpu")
    rng = np.random.default_rng(12)
    shp = (jcfg.n_layers, 2, jcfg.n_kv_heads, 16, jcfg.head_dim)
    k = rng.standard_normal(shp).astype(np.float32)
    v = rng.standard_normal(shp).astype(np.float32)
    tokens = np.array([[3], [4]], np.int32)
    lengths = np.array([16, 7], np.int32)
    jl, jk, _ = jdec.forward_with_cache(
        jax.tree_util.tree_map(jnp.asarray, jp), jcfg, jnp.asarray(tokens),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths))
    tk = torch.tensor(k)
    tl, tk, _ = tdec.forward_with_cache(tp, tcfg, torch.tensor(tokens).long(),
                                        tk, torch.tensor(v),
                                        torch.tensor(lengths))
    jl = np.asarray(jl)
    np.testing.assert_allclose(tl.numpy(), jl, rtol=0,
                               atol=1e-4 * np.abs(jl).max())
    np.testing.assert_array_equal(tk[:, 0].numpy(), k[:, 0])
    _assert_caches_equal(tk, jk)


def _qkv(B, H, KvH, S=16, hd=8):
    return (torch.randn(B, 1, H, hd), torch.randn(B, KvH, S, hd),
            torch.randn(B, KvH, S, hd))


@pytest.mark.parametrize("H,KvH,env,kernels,expect", [
    (4, 2, {}, "auto", "decode_attention_plain"),
    (4, 2, {"TPU_MHA_KERNEL": "1"}, "auto", "decode_attention_plain"),
    (4, 4, {}, "auto", "attend_hf"),
    (4, 4, {"TPU_MHA_KERNEL": "1"}, "auto", "mha_decode_attention_plain"),
    (4, 4, {}, "pallas", "decode_attention_plain"),
    (4, 4, {"OLLAMA_TPU_KERNELS": "pallas"}, "auto",
     "decode_attention_plain")])
def test_cached_attention_routes_like_jax(H, KvH, env, kernels, expect,
                                          monkeypatch):
    """T=1: MHA with TPU_MHA_KERNEL=1 → K3; GQA, or MHA with an explicit
    pallas choice → K2; MHA otherwise → the einsum. T>1 → the einsum."""
    for name in ("TPU_MHA_KERNEL", "OLLAMA_TPU_KERNELS"):
        monkeypatch.delenv(name, raising=False)
    for name, val in env.items():
        monkeypatch.setenv(name, val)
    calls = []
    for name in ("decode_attention_plain", "mha_decode_attention_plain",
                 "attend_hf"):
        real = getattr(tattn, name)
        monkeypatch.setattr(tattn, name, functools.partial(
            lambda real, name, *a, **kw: calls.append(name) or real(*a, **kw),
            real, name))
    cfg = dataclasses.replace(TPRESETS["tiny"], n_heads=H, n_kv_heads=KvH,
                              head_dim=8, kernels=kernels)
    q, k, v = _qkv(2, H, KvH)
    q_pos = torch.tensor([[3], [15]], dtype=torch.int32)
    mask = torch.zeros((2, 1, 1, 8))
    out = tattn.cached_attention(cfg, q, k, v, mask, q_pos, 0.5, attn_len=8)
    assert calls == [expect] and out.shape == q.shape
    calls.clear()
    q2 = torch.randn(2, 3, H, 8)
    tattn.cached_attention(cfg, q2, k, v, torch.zeros((2, 1, 3, 16)),
                           q_pos.expand(2, 3), 0.5)
    assert calls == ["attend_hf"]


MOE = TPRESETS["tiny-moe"]
GQA = TPRESETS["llama3.2:3b"]
PHI3 = TPRESETS["phi3"]


@pytest.mark.parametrize("cfg,device,paged,expect", [
    # (config, device, explicit flag) → (paged, slots, page size, pages,
    # decode chunk) at max_seq_len 4096 with auto slots and page size
    (GQA, "cuda", None, (True, 64, 128, 768, 32)),
    (PHI3, "cuda", None, (True, 32, 64, 512, 32)),
    (MOE, "cuda", None, (False, 8, 64, None, 32)),
    (GQA, "cpu", None, (False, 8, 64, None, 8)),
    (PHI3, "cpu", None, (False, 8, 64, None, 8)),
    (MOE, "cpu", None, (False, 8, 64, None, 8)),
    (GQA, "cuda", False, (False, 8, 64, None, 32)),
    (PHI3, "cuda", False, (False, 8, 64, None, 32)),
    (GQA, "cpu", True, (True, 32, 64, 512, 8)),
    (MOE, "cuda", True, (True, 64, 128, 768, 32))])
def test_serving_defaults_table(cfg, device, paged, expect):
    e = resolve_serving_defaults(
        EngineConfig(max_slots=0, decode_chunk=0, page_size=0, paged=paged,
                     max_seq_len=4096), cfg, device)
    n_pages = None if expect[3] is None else \
        expect[3] * min(4096, cfg.max_seq_len) // 4096
    assert (e.paged, e.max_slots, e.page_size, e.n_pages,
            e.decode_chunk) == expect[:3] + (n_pages, expect[4])
    if paged is None:
        assert resolve_paged_default(cfg, device) == expect[0]
    # explicit slots keep the caller's sizing; only chunk and page resolve
    e = resolve_serving_defaults(
        EngineConfig(max_slots=4, decode_chunk=0, page_size=0,
                     paged=bool(paged)), cfg, device)
    assert (e.max_slots, e.n_pages, e.paged) == (4, None, bool(paged))


def test_dense_engine_refuses_int4_and_skips_page_bookkeeping():
    cfg = TPRESETS["tiny"]
    params = tdec.init_params(cfg,
                              torch.Generator(device="cpu").manual_seed(0),
                              torch.float32, "cpu")
    with pytest.raises(ValueError, match="requires the paged cache"):
        Engine(cfg, params, EngineConfig(max_slots=2, max_seq_len=64,
                                         cache_dtype="int4"), device="cpu")
    e = Engine(cfg, params, EngineConfig(max_slots=2, max_seq_len=64,
                                         cache_dtype=torch.int8),
               device="cpu")
    assert not e.paged and e._pt is None
    assert e.k_cache["q"].shape == (2, 2, 2, 64, 16)
    assert e.k_cache["s"].shape == (2, 2, 2, 64)
    assert e.can_admit(0, 63) and not e.can_admit(0, 64)
    assert e.admissible(63) and not e.admissible(64)
    assert e.prepare_decode() == []


def test_card_refuses_a_float32_cache():
    """No decode kernel on the card takes an f32 cache, so the engine
    refuses one when it is built, not at its first decode step."""
    for dev in ("cuda", torch.device("cuda")):
        for dt in ("float32", torch.float32):
            with pytest.raises(ValueError, match="float32 KV cache"):
                resolve_cache_dtype(dt, dev)
    assert resolve_cache_dtype("float32", "cpu") is torch.float32
    assert resolve_cache_dtype("float32") is torch.float32
    assert resolve_cache_dtype("bfloat16", "cuda") is torch.bfloat16
    assert resolve_cache_dtype("int8", "cuda") is torch.int8


def test_build_tag_covers_shared_headers(tmp_path, monkeypatch):
    """A library's name hashes its source and every csrc/*.cuh, so an
    edited shared header never loads a stale build."""
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    first = cuda_build._lib_path("k")
    assert cuda_build._lib_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    second = cuda_build._lib_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "other.cuh").write_text("// new\n")
    assert cuda_build._lib_path("k") != second
    (tmp_path / "k.cu").write_text('#include "common.cuh"\n// edit\n')
    assert cuda_build._lib_path("k") not in (first, second)


def test_http_generate_on_the_dense_cache():
    p = tdec.init_params(TPRESETS["tiny"],
                         torch.Generator(device="cpu").manual_seed(4),
                         torch.float32, "cpu")
    mm = ModelManager(device="cpu")
    lm = mm.preload("tiny", TPRESETS["tiny"], p,
                    Tokenizer(model="llama", **BYTES),
                    template="{{ .Prompt }}", paged=False)
    assert not lm.engine.paged and lm.ecfg.max_slots == 8
    assert lm.engine.k_cache.shape == (2, 8, 2, 128, 16)
    httpd = serve(mm, "127.0.0.1", 0)
    try:
        body = {"model": "tiny", "prompt": "dense cache", "stream": False,
                "options": {"temperature": 0, "num_predict": 12}}
        req = urllib.request.Request(
            f"http://127.0.0.1:{httpd.server_address[1]}/api/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            out = json.loads(r.read())
        assert out["done"] and out["eval_count"] == 12
        direct = lm.generate("dense cache",
                             {"temperature": 0, "num_predict": 12})
        assert direct.context == out["context"]
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()
