"""Decoder-only transformer (llama family) in PyTorch.

Counterpart of ``ollama_operator_tpu/models/decoder.py`` for the paged
and the dense slot-cache serving paths: ``init_params``,
``prefill_chunk``, ``paged_insert``, and ``forward_with_cache_paged`` and
``forward_with_cache``: decode steps at T=1, prefix-cache and
chunked-prefill extends (a B=1 tail over a prior cache) at T>1. The
params tree keeps the JAX
package's layout (plain dicts of tensors, layer leaves stacked on a
leading ``n_layers`` axis, weights ``[K, O]``, quantized leaves as
``{"q4", "s"}`` / ``{"q", "s"}`` dicts):

  tok_emb [V, D]   out_norm_w [D]   lm_head [D, V] (absent when tied)
  layers/ attn_norm_w [L, D]  wq [L, D, H*hd]  wk/wv [L, D, KvH*hd]
          wo [L, H*hd, D]  mlp_norm_w [L, D]
          w_gate/w_up [L, D, F]  w_down [L, F, D]  (bq/bk/bv optional)

Layers run as a Python loop (PyTorch is eager; the JAX package scans).
The KV pools and caches are updated in place (the JAX functions are pure
and return new ones; here the same tensors come back), which saves a
cache-sized copy per step. On the card every int4 projection runs the qmm4
kernel, every int8 projection the qmm kernel, prefill attention the
flash-prefill kernel, paged decode attention the paged-decode kernel (int8,
int4 or bf16 pool) and dense-cache decode attention the GQA or MHA decode
kernel (bf16 cache; an int8 dense cache attends through the plain
``attend_hf_q``, as the JAX package attends it in XLA; ``ops/``); on the
CPU the same calls run their plain versions. An extend tail (T>1)
attends through the gather + einsum path (``attend_hf`` /
``attend_hf_q`` / ``attend_hf_q4``), which the JAX package runs in XLA
too, so no kernel of its own. A tied LM
head (``tok_emb.T``) stays a bf16 ``torch.matmul``, as the JAX package
leaves it outside any Pallas kernel.

Architecture features outside this slice (layernorm, parallel blocks,
MoE, alternating sliding attention, qk-norm, sandwich norms, plain MLPs,
output biases) raise in :func:`check_supported`.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import quant as Q
from ..ops.attention import NEG_INF, cached_attention, chunk_attention
from ..ops.norms import rms_norm
from ..ops.attention import attend_hf
from ..ops.paged import _gather_pages, paged_decode_attention
from ..ops.quant_cache import (INT4_BIAS, attend_hf_q, attend_hf_q4, pack_kv4,
                               pool_codes, quantize_kv, quantize_kv4)
from ..ops.rope import apply_rope, rope_angles_cfg
from .config import ModelConfig

Params = Dict[str, Any]

# page 0 of every pool is the trash page (runtime/paged.TRASH_PAGE)
TRASH_PAGE = 0


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """Raise for architecture features this port does not run yet."""
    missing = [name for name, on in (
        ("layernorm", cfg.norm_type != "rmsnorm"),
        ("parallel_block", cfg.parallel_block),
        ("mixture of experts", cfg.n_experts > 0),
        ("altern_sliding", cfg.altern_sliding),
        ("qk_norm", cfg.qk_norm),
        ("post_norms", cfg.post_norms),
        ("plain mlp", cfg.mlp_type != "gated"),
        ("out_bias", cfg.out_bias)) if on]
    if missing:
        raise NotImplementedError(
            f"the torch port does not run {', '.join(missing)} yet")
    return cfg


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.bfloat16,
                device="cuda") -> Params:
    """Random weights with the JAX package's distributions (normal with
    std 0.02 for matrices, ones for norm weights, zeros for biases); the
    bits differ, since the generators differ. Each leaf is filled one
    [K, O] slice at a time, so f32 temporaries stay one slice big. The
    weights go to the card unless the caller names the CPU (raises
    without CUDA); ``generator`` must live on ``device``."""
    check_supported(cfg)
    device = resolve_device(device)
    L, D, Fd, V = cfg.n_layers, cfg.dim, cfg.ffn_dim, cfg.vocab_size

    def w(*shape, scale=0.02):
        out = torch.empty(shape, dtype=dtype, device=device)
        flat = out.reshape(-1, *shape[-2:])
        for i in range(flat.shape[0]):
            flat[i] = torch.randn(shape[-2:], generator=generator,
                                  dtype=torch.float32, device=device) * scale
        return out

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    layers = {"attn_norm_w": ones(L, D),
              "wq": w(L, D, cfg.q_dim), "wk": w(L, D, cfg.kv_dim),
              "wv": w(L, D, cfg.kv_dim), "wo": w(L, cfg.q_dim, D),
              "w_up": w(L, D, Fd), "w_down": w(L, Fd, D),
              "mlp_norm_w": ones(L, D), "w_gate": w(L, D, Fd)}
    if cfg.attn_bias:
        for k, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                     ("bv", cfg.kv_dim)):
            layers[k] = torch.zeros((L, n), dtype=dtype, device=device)
    params: Params = {"tok_emb": w(V, D), "out_norm_w": ones(D),
                      "layers": layers}
    if not cfg.tie_embeddings:
        params["lm_head"] = w(D, V)
    return params


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale_mult:
        return cfg.attn_scale_mult
    return 1.0 / math.sqrt(cfg.attn_scale or cfg.head_dim)


def _norm(cfg: ModelConfig, x, w):
    return rms_norm(x, w, cfg.norm_eps, cfg.norm_weight_offset)


def _act(cfg: ModelConfig, x):
    if cfg.act == "silu":
        return F.silu(x)
    return F.gelu(x, approximate="none" if cfg.act == "gelu" else "tanh")


def _layer(params: Params, i: int) -> Dict[str, Any]:
    """Layer ``i``'s leaves (views into the stacked tensors)."""
    return {k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
                else v[i]) for k, v in params["layers"].items()}


def _qkv(cfg: ModelConfig, lp, h, cos, sin):
    B, T, _ = h.shape
    q = Q.matmul(h, lp["wq"])
    k = Q.matmul(h, lp["wk"])
    v = Q.matmul(h, lp["wv"])
    if "bq" in lp:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, T, cfg.n_heads, cfg.head_dim)
    k = k.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(B, T, cfg.n_kv_heads, cfg.head_dim)
    return (apply_rope(q, cos, sin, cfg.rotary_dim),
            apply_rope(k, cos, sin, cfg.rotary_dim), v)


def _mlp(cfg: ModelConfig, lp, x):
    g = _act(cfg, Q.matmul(x, lp["w_gate"]))
    u = Q.matmul(x, lp["w_up"])
    return Q.matmul(g * u, lp["w_down"])


def _residual(cfg: ModelConfig, lp, x, attn):
    rm = cfg.residual_multiplier or 1.0
    x = x + rm * attn
    return x + rm * _mlp(cfg, lp, _norm(cfg, x, lp["mlp_norm_w"]))


def _embed(cfg: ModelConfig, params: Params, tokens):
    x = params["tok_emb"][tokens]
    if cfg.emb_scale:
        x = (x.float() * math.sqrt(cfg.dim)).to(x.dtype)
    if cfg.emb_multiplier:
        x = (x.float() * cfg.emb_multiplier).to(x.dtype)
    return x


def _mm_f32(x, w):
    """x [..., D] @ w [D, V] → f32, as the JAX package's einsum with
    ``preferred_element_type=float32``: the product of the operands as they
    are, summed in f32, never rounded to their dtype first. On the card a
    bf16 pair goes to one GEMM with an f32 output (``aten::mm.dtype``); on
    the CPU the operands are widened (a bf16 times a bf16 is exact in
    f32)."""
    x2 = x.reshape(-1, x.shape[-1])
    if x2.is_cuda and x2.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(x2, w, out_dtype=torch.float32)
    else:
        y = x2.float() @ w.float()
    return y.reshape(*x.shape[:-1], w.shape[-1])


def _unembed(cfg: ModelConfig, params: Params, x):
    """Final norm + LM head → f32 logits."""
    x = _norm(cfg, x, params["out_norm_w"])
    if not cfg.tie_embeddings and Q.is_quantized(params["lm_head"]):
        logits = Q.matmul(x, params["lm_head"], out_dtype=torch.float32)
    else:
        head = (params["tok_emb"].t() if cfg.tie_embeddings
                else params["lm_head"])
        logits = _mm_f32(x, head)
    if cfg.logit_scale:
        logits = logits / cfg.logit_scale
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def prefill_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layers of :func:`prefill_chunk` without the LM head: returns
    (hidden [B, T, D], k [L, B, KvH, T, hd], v [...]). The engine
    unembeds only the row it samples from."""
    B, T = tokens.shape
    scale = _attn_scale(cfg)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    cos, sin = rope_angles_cfg(positions, cfg)
    x = _embed(cfg, params, tokens)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _norm(cfg, x, lp["attn_norm_w"])
        q, k, v = _qkv(cfg, lp, h, cos, sin)
        k = k.transpose(1, 2)                          # [B, KvH, T, hd]
        v = v.transpose(1, 2)
        attn = chunk_attention(cfg, q, k, v, scale)
        x = _residual(cfg, lp, x, Q.matmul(attn.reshape(B, T, -1), lp["wo"]))
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def prefill_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A fresh chunk at positions [0, T) with no prior cache.

    tokens [B, T] (right-padded; callers read logits at n_valid-1).
    Returns (logits [B, T, V] f32, k [L, B, KvH, T, hd], v [...]), K/V
    head-first like the cache."""
    x, ks, vs = prefill_hidden(params, cfg, tokens)
    return _unembed(cfg, params, x), ks, vs


def _pool_dims(k_pool) -> Tuple[int, ...]:
    """(L, P, KvH, ps, hd) of a pool, ps the logical page size (an int4
    pool stores ps/2 byte rows a page)."""
    if not isinstance(k_pool, dict):
        return tuple(k_pool.shape)
    L, P, KvH, ps = k_pool["s"].shape
    return L, P, KvH, ps, pool_codes(k_pool).shape[-1]


def paged_insert(cfg: ModelConfig, k_pool, v_pool, ks, vs,
                 table_row: torch.Tensor, n_valid: int):
    """Insert a fresh B=1 prefill chunk (ks/vs [L, 1, KvH, Tb, hd] from
    :func:`prefill_chunk`) into the pool pages listed by ``table_row``
    [NBLK]. Positions >= n_valid go to the trash page, so an admission
    allocates pages only for real tokens. Updates the pools in place and
    returns them.

    int4 pools: admissions start at offset 0, so the nibble pairs
    (2j, 2j + 1) are byte-aligned and pack directly. As in the JAX
    package, a pair goes to its even member's page, so a pair straddling
    ``n_valid`` writes its padding half one position past the slot's
    length (never attended; the next decode write replaces it) while
    that position's scale goes to the trash page."""
    L, P, KvH, ps, hd = _pool_dims(k_pool)
    Tb = ks.shape[3]
    dev = ks.device
    t = torch.arange(Tb, device=dev)
    pg = torch.where(t < n_valid, table_row.long()[t // ps],
                     torch.full_like(t, TRASH_PAGE))
    lx = torch.arange(L, device=dev)[:, None, None]
    hx = torch.arange(KvH, device=dev)[None, :, None]
    idx = (lx, pg[None, None, :], hx, (t % ps)[None, None, :])
    if isinstance(k_pool, dict) and "q4" in k_pool:
        idx4 = (lx, pg[0::2][None, None, :], hx,
                ((t % ps)[0::2] // 2)[None, None, :])
        for pool, x in ((k_pool, ks), (v_pool, vs)):
            codes, scales = quantize_kv4(x[:, 0])
            pool["q4"][idx4] = pack_kv4(codes)
            pool["s"][idx] = scales
    elif isinstance(k_pool, dict):
        for pool, x in ((k_pool, ks), (v_pool, vs)):
            codes, scales = quantize_kv(x[:, 0])
            pool["q"][idx] = codes
            pool["s"][idx] = scales
    else:
        k_pool[idx] = ks[:, 0].to(k_pool.dtype)
        v_pool[idx] = vs[:, 0].to(v_pool.dtype)
    return k_pool, v_pool


def _scatter4(pool4: torch.Tensor, codes: torch.Tensor, pg, off):
    """Merge int4 codes [B, KvH, T, hd] into one layer's nibble-packed
    pool [P, KvH, ps/2, hd] at byte row off // 2: a read-modify-write, one
    offset parity at a time (two even offsets never share a byte, so a
    pass has no conflicting writes, and the odd pass reads the even
    pass's bytes). An extend tail starting at an odd offset shares its
    first byte with the prefix's last code; the read-modify-write keeps
    that nibble. Entries of the other parity are sent to the trash page,
    whose contents are never attended (the JAX package drops them with an
    out-of-bounds write). In place."""
    hx = torch.arange(codes.shape[1], device=codes.device)[None, :, None]
    nib = (codes.to(torch.int16) + INT4_BIAS).to(torch.uint8) & 0xF
    for parity, keep, put in ((0, 0xF0, nib), (1, 0x0F, nib << 4)):
        sel = (off % 2) == parity
        idx = (torch.where(sel, pg, TRASH_PAGE)[:, None, :], hx,
               torch.where(sel, off // 2, 0)[:, None, :])
        pool4[idx] = (pool4[idx] & keep) | put


def _scatter_kv_pools(kp, vp, i: int, k, v, pg_w, off_w):
    """Quantize (int8/int4 pools) and write one layer's fresh K/V
    [B, KvH, T, hd] into the pools at (page, offset) per (row, position);
    pg_w/off_w [B, T]. In place."""
    KvH = k.shape[1]
    idx = (pg_w[:, None, :],
           torch.arange(KvH, device=k.device)[None, :, None],
           off_w[:, None, :])
    if isinstance(kp, dict) and "q4" in kp:
        for pool, x in ((kp, k), (vp, v)):
            codes, scales = quantize_kv4(x)
            _scatter4(pool["q4"][i], codes, pg_w, off_w)
            pool["s"][i][idx] = scales
    elif isinstance(kp, dict):
        for pool, x in ((kp, k), (vp, v)):
            codes, scales = quantize_kv(x)
            pool["q"][i][idx] = codes
            pool["s"][i][idx] = scales
    else:
        kp[i][idx] = k.to(kp.dtype)
        vp[i][idx] = v.to(vp.dtype)


def _window_mask(positions, S: int, window: int):
    """Additive [B, 1, T, S] f32 mask: query t of row b at absolute
    position positions[b, t] sees keys j <= it (within ``window``)."""
    k_pos = torch.arange(S, device=positions.device)[None, None, :]
    q_pos = positions[:, :, None]
    ok = k_pos <= q_pos
    if window:
        ok = ok & (k_pos > q_pos - window)
    zero = torch.zeros((), dtype=torch.float32, device=positions.device)
    return torch.where(ok, zero, NEG_INF)[:, None]


def _paged_gather_attend(cfg: ModelConfig, q, kp, vp, i: int, tbl, mask,
                         scale: float):
    """An extend tail's attention over the paged pool: gather layer
    ``i``'s pages ``tbl`` [B, NA] into a contiguous view and attend it
    with the masked einsum of the pool's kind (the JAX package's
    ``_paged_attend`` gather path; its pools pad hd to 128 lanes and slice
    the pad back, the port's pools are not padded)."""
    if not isinstance(kp, dict):
        return attend_hf(q, _gather_pages(kp, i, tbl),
                         _gather_pages(vp, i, tbl), mask, scale,
                         cfg.attn_softcap)
    key = "q4" if "q4" in kp else "q"
    kw, vw = ({key: _gather_pages(p[key], i, tbl),
               "s": _gather_pages(p["s"], i, tbl)} for p in (kp, vp))
    attend = attend_hf_q4 if key == "q4" else attend_hf_q
    return attend(q, kw, vw, mask, scale, cfg.attn_softcap)


def forward_with_cache_paged(params: Params, cfg: ModelConfig,
                             tokens: torch.Tensor, k_pool, v_pool,
                             tables: torch.Tensor, lengths: torch.Tensor,
                             attn_blocks: int, hidden: bool = False):
    """Extend rows that have ``lengths`` cached tokens in the paged pool.

    tokens [B, T]: T=1 is the decode step, T>1 an extend tail (B=1 in the
    engine: a prefix-cache continuation or a chunked-prefill piece);
    tables [B, NBLK] int32 physical page per logical block; lengths [B]
    int32 cached tokens per row. New token t of row b sits at position
    lengths[b] + t, which rope takes, and is written to page
    tables[b, (lengths[b] + t) // ps] before attention (the trash page
    for blocks past the table, never the row's last live page, which may
    hold a shared prefix), and attention includes it. ``attn_blocks``
    bounds the attended width in blocks: at T=1 the paged-decode kernel
    of the route, at T>1 a gather of the first ``attn_blocks`` pages and
    the masked einsum. Returns (logits [B, T, V] f32, or the final hidden
    states [B, T, D] with ``hidden``, k_pool, v_pool), pools updated in
    place."""
    B, T = tokens.shape
    L, P, KvH, ps, hd = _pool_dims(k_pool)
    scale = _attn_scale(cfg)
    positions = lengths.long()[:, None]                     # [B, 1]
    if T > 1:
        positions = positions + torch.arange(T, device=tokens.device)
        mask = _window_mask(positions, attn_blocks * ps, cfg.sliding_window)
        tbl = tables[:, :attn_blocks].long()
    cos, sin = rope_angles_cfg(positions, cfg)
    NBLK = tables.shape[1]
    blk = positions // ps
    pg_w = torch.where(blk < NBLK,
                       tables.long().gather(1, blk.clamp(max=NBLK - 1)),
                       torch.full_like(blk, TRASH_PAGE))
    off_w = positions % ps
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _norm(cfg, x, lp["attn_norm_w"])
        q, k, v = _qkv(cfg, lp, h, cos, sin)
        _scatter_kv_pools(k_pool, v_pool, i, k.transpose(1, 2),
                          v.transpose(1, 2), pg_w, off_w)
        if T == 1:
            attn = paged_decode_attention(
                q, k_pool, v_pool, i, tables, lengths, scale,
                cfg.attn_softcap, cfg.sliding_window, nblk=attn_blocks)
        else:
            attn = _paged_gather_attend(cfg, q, k_pool, v_pool, i, tbl,
                                        mask, scale)
        x = _residual(cfg, lp, x, Q.matmul(attn.reshape(B, T, -1), lp["wo"]))
    return (x if hidden else _unembed(cfg, params, x)), k_pool, v_pool


# --------------------------------------------------------------------------
# dense slot cache: [L, B, KvH, S, hd] head-first (int8: {"q": int8 codes,
# "s": [L, B, KvH, S] f32 scales})
# --------------------------------------------------------------------------

def dense_insert(k_cache, v_cache, ks, vs, slot: int):
    """Copy a fresh B=1 prefill chunk (ks/vs [L, 1, KvH, Tb, hd] from
    :func:`prefill_chunk`) into rows [0, Tb) of ``slot``, bucket padding
    included, as the JAX engine's dynamic_update_slice does (rows past the
    prompt are masked until decode steps overwrite them). int8 caches
    take the quantized codes and scales. In place."""
    Tb = ks.shape[3]
    if isinstance(k_cache, dict):
        for cache, x in ((k_cache, ks), (v_cache, vs)):
            codes, scales = quantize_kv(x[:, 0])
            cache["q"][:, slot, :, :Tb] = codes
            cache["s"][:, slot, :, :Tb] = scales
    else:
        k_cache[:, slot, :, :Tb] = ks[:, 0].to(k_cache.dtype)
        v_cache[:, slot, :, :Tb] = vs[:, 0].to(v_cache.dtype)


def _dense_write(cache, i: int, x, bx, hx, pos_w, keep):
    """Write one layer's new rows x [B, KvH, 1(, hd)] at (b, h, pos_w[b])
    of ``cache[i]``, in place. A row whose position is past the cache
    (``keep`` false: a slot decoding past its context) keeps the old
    value, as the JAX package drops out-of-bounds writes."""
    layer = cache[i]
    old = layer[bx, hx, pos_w]
    layer[bx, hx, pos_w] = torch.where(keep, x.to(layer.dtype), old)


def forward_with_cache(params: Params, cfg: ModelConfig,
                       tokens: torch.Tensor, k_cache, v_cache,
                       lengths: torch.Tensor, attn_len=None,
                       hidden: bool = False):
    """Extend rows that have ``lengths`` cached tokens in the dense slot
    cache.

    tokens [B, T]: T=1 is the decode step, T>1 an extend tail (B=1 in the
    engine, over a view of the slot's rows); k_cache/v_cache [L, B, KvH,
    S, hd] (bf16/f32) or int8 dicts; lengths [B] int32 cached tokens per
    row. As in the JAX package, each layer first writes the new tokens'
    K/V at positions lengths[b] + t (dropped past S), then attends keys
    0 .. lengths[b] + t within the window, read from cache positions
    [0, attn_len) (``attn_len`` None = S; it must cover max(lengths) + T):
    bf16/f32 caches through :func:`cached_attention` (the decode kernels
    at T=1, the masked einsum at T>1), int8 caches through
    :func:`attend_hf_q`. Returns (logits [B, T, V] f32, or the final
    hidden states [B, T, D] with ``hidden``, k_cache, v_cache), the caches
    updated in place."""
    B, T = tokens.shape
    quant = isinstance(k_cache, dict)
    L, _, KvH, S, hd = (k_cache["q"] if quant else k_cache).shape
    A = S if attn_len is None else min(attn_len, S)
    scale = _attn_scale(cfg)
    dev = tokens.device
    q_pos = lengths[:, None]                                # [B, 1] int32
    if T > 1:
        q_pos = q_pos + torch.arange(T, device=dev, dtype=q_pos.dtype)
    positions = q_pos.long()
    cos, sin = rope_angles_cfg(positions, cfg)
    mask = _window_mask(positions, A, cfg.sliding_window)  # [B, 1, T, A]
    bx = torch.arange(B, device=dev)[:, None, None]
    hx = torch.arange(KvH, device=dev)[None, :, None]
    pos_w = positions.clamp(max=S - 1)[:, None, :]          # [B, 1, T]
    keep = (positions < S)[:, None, :]
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _norm(cfg, x, lp["attn_norm_w"])
        q, k, v = _qkv(cfg, lp, h, cos, sin)
        k = k.transpose(1, 2)                              # [B, KvH, T, hd]
        v = v.transpose(1, 2)
        if quant:
            for cache, val in ((k_cache, k), (v_cache, v)):
                codes, scales = quantize_kv(val)
                _dense_write(cache["q"], i, codes, bx, hx, pos_w,
                             keep[..., None])
                _dense_write(cache["s"], i, scales, bx, hx, pos_w, keep)
            kwin = {n: t[i, :, :, :A] for n, t in k_cache.items()}
            vwin = {n: t[i, :, :, :A] for n, t in v_cache.items()}
            attn = attend_hf_q(q, kwin, vwin, mask, scale, cfg.attn_softcap)
        else:
            _dense_write(k_cache, i, k, bx, hx, pos_w, keep[..., None])
            _dense_write(v_cache, i, v, bx, hx, pos_w, keep[..., None])
            attn = cached_attention(cfg, q, k_cache[i], v_cache[i], mask,
                                    q_pos, scale, attn_len=A)
        x = _residual(cfg, lp, x, Q.matmul(attn.reshape(B, T, -1), lp["wo"]))
    return (x if hidden else _unembed(cfg, params, x)), k_cache, v_cache
