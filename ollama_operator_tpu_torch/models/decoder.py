"""Decoder-only transformer (the JAX package's dense families) in PyTorch.

Counterpart of ``ollama_operator_tpu/models/decoder.py`` for the paged
and the dense slot-cache serving paths: ``init_params``,
``prefill_chunk``, ``paged_insert``, and ``forward_with_cache_paged`` and
``forward_with_cache``: decode steps at T=1, prefix-cache and
chunked-prefill extends (a B=1 tail over a prior cache) at T>1. The
params tree keeps the JAX
package's layout (plain dicts of tensors, layer leaves stacked on a
leading ``n_layers`` axis, weights ``[K, O]``, quantized leaves as
``{"q4", "s"}`` / ``{"q", "s"}`` dicts):

  tok_emb [V, D]   out_norm_w [D] (+ out_norm_b, layernorm archs)
  lm_head [D, V] (absent when tied)   lm_head_b [V] (out_bias archs)
  layers/ attn_norm_w [L, D] (+ attn_norm_b)  wq [L, D, H*hd]
          wk/wv [L, D, KvH*hd]  wo [L, H*hd, D]  (bq/bk/bv, bo optional)
          mlp_norm_w [L, D] (+ mlp_norm_b; absent with parallel_block)
          w_gate [L, D, F] (gated MLPs)  w_up [L, D, F]  w_down [L, F, D]
          (b_up [L, F], b_down [L, D] with out_bias)
          mixture of experts instead of w_gate/w_up/w_down: router [L, D, E]
          we_gate/we_up [L, E, D, F]  we_down [L, E, F, D]  (qwen2moe's
          shared expert: we_sh_gate/we_sh_up [L, D, Fs]  we_sh_down
          [L, Fs, D]  sh_gate [L, D, 1])
          q_norm_w/k_norm_w [L, hd] (qk_norm)
          post_attn_norm_w/post_ffw_norm_w [L, D] (post_norms)

The block variants are the JAX package's: RMSNorm or LayerNorm (with or
without biases), qk-norm, gemma2's sandwich norms, phi2's parallel block,
plain (biased) or gated MLPs, partial rotary, and the alternating
sliding/full attention of gemma2 and gemma3 with gemma3's dual rope (a
local theta on the sliding layers).

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
leaves it outside any Pallas kernel. Alternating archs (gemma2, gemma3)
take no attention kernel on any path, as in the JAX package, whose kernel
dispatch needs one static window: prefill and dense decode attend through
the masked einsum, paged decode through the gather + einsum, each layer
with its own window.

Mixture-of-experts MLPs (mixtral, qwen2moe, qwen3moe) route each token
to its top-k experts (:func:`_moe_gates`) and run the experts as plain
matmuls (:func:`_moe_mlp`), as the JAX package runs them outside any
Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..device import resolve_device
from ..ops import quant as Q
from ..ops.attention import NEG_INF, cached_attention, chunk_attention
from ..ops.attention import attend_hf, causal_mask
from ..ops.norms import layer_norm, rms_norm
from ..ops.paged import _gather_pages, paged_decode_attention
from ..ops.quant_cache import (INT4_BIAS, attend_hf_q, attend_hf_q4, pack_kv4,
                               pool_codes, quantize_kv, quantize_kv4)
from ..ops.rope import apply_rope, rope_angles, rope_angles_cfg
from .config import ModelConfig

Params = Dict[str, Any]

# page 0 of every pool is the trash page (runtime/paged.TRASH_PAGE)
TRASH_PAGE = 0


def check_supported(cfg: ModelConfig) -> ModelConfig:
    """Raise ``NotImplementedError`` (which the model manager answers with
    501) for an architecture the port does not run, else return ``cfg``.
    It raises for none: every one the JAX decoder runs (each dense family
    and mixture of experts) runs here."""
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

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    ln_bias = cfg.norm_type == "layernorm" and cfg.norm_bias
    layers = {"attn_norm_w": ones(L, D),
              "wq": w(L, D, cfg.q_dim), "wk": w(L, D, cfg.kv_dim),
              "wv": w(L, D, cfg.kv_dim), "wo": w(L, cfg.q_dim, D)}
    if cfg.n_experts:
        E = cfg.n_experts
        layers.update(router=w(L, D, E), we_gate=w(L, E, D, Fd),
                      we_up=w(L, E, D, Fd), we_down=w(L, E, Fd, D))
        if cfg.n_shared_ffn:
            Fs = cfg.n_shared_ffn
            layers.update(we_sh_gate=w(L, D, Fs), we_sh_up=w(L, D, Fs),
                          we_sh_down=w(L, Fs, D), sh_gate=w(L, D, 1))
    else:
        layers.update(w_up=w(L, D, Fd), w_down=w(L, Fd, D))
    if ln_bias:
        layers["attn_norm_b"] = zeros(L, D)
    if not cfg.parallel_block:
        layers["mlp_norm_w"] = ones(L, D)
        if ln_bias:
            layers["mlp_norm_b"] = zeros(L, D)
    if cfg.mlp_type == "gated" and not cfg.n_experts:
        layers["w_gate"] = w(L, D, Fd)
    if cfg.attn_bias:
        for k, n in (("bq", cfg.q_dim), ("bk", cfg.kv_dim),
                     ("bv", cfg.kv_dim)):
            layers[k] = zeros(L, n)
    if cfg.out_bias:
        layers.update(bo=zeros(L, D), b_up=zeros(L, Fd), b_down=zeros(L, D))
    if cfg.qk_norm:
        layers.update(q_norm_w=ones(L, cfg.head_dim),
                      k_norm_w=ones(L, cfg.head_dim))
    if cfg.post_norms:
        layers.update(post_attn_norm_w=ones(L, D),
                      post_ffw_norm_w=ones(L, D))
    params: Params = {"tok_emb": w(V, D), "out_norm_w": ones(D),
                      "layers": layers}
    if ln_bias:
        params["out_norm_b"] = zeros(D)
    if not cfg.tie_embeddings:
        params["lm_head"] = w(D, V)
    if cfg.out_bias:
        params["lm_head_b"] = zeros(V)
    return params


# --------------------------------------------------------------------------
# building blocks
# --------------------------------------------------------------------------

def _attn_scale(cfg: ModelConfig) -> float:
    if cfg.attn_scale_mult:
        return cfg.attn_scale_mult
    return 1.0 / math.sqrt(cfg.attn_scale or cfg.head_dim)


def _norm(cfg: ModelConfig, x, w, b=None):
    if cfg.norm_type == "layernorm":
        return layer_norm(x, w, b, cfg.norm_eps)
    return rms_norm(x, w, cfg.norm_eps, cfg.norm_weight_offset)


def _is_full_layer(cfg: ModelConfig, i: int) -> bool:
    """Alternating attention: layer i attends in full iff i % pattern ==
    pattern - 1 (gemma2: odd layers; gemma3: every 6th)."""
    return i % cfg.sliding_pattern == cfg.sliding_pattern - 1


def _layer_window(cfg: ModelConfig, i: int) -> int:
    """Layer i's sliding window (0 = full attention): an alternating
    arch's full layers attend everything, every other layer takes the
    config's window."""
    if cfg.altern_sliding and _is_full_layer(cfg, i):
        return 0
    return cfg.sliding_window


def _rope_pair(positions, cfg: ModelConfig):
    """(cos, sin, cos_l, sin_l): the global table with the model's scaling
    and, for dual-rope archs (gemma3), the unscaled local-theta table
    (None otherwise)."""
    cos, sin = rope_angles_cfg(positions, cfg)
    if not cfg.rope_local_theta:
        return cos, sin, None, None
    cos_l, sin_l = rope_angles(positions, cfg.rotary_dim,
                               cfg.rope_local_theta)
    return cos, sin, cos_l, sin_l


def _layer_rope(cfg: ModelConfig, i: int, rope):
    """Layer i's (cos, sin): a dual-rope arch's sliding layers rotate at
    the local theta, its full layers (and every layer of the others) at
    the global one."""
    cos, sin, cos_l, sin_l = rope
    if cos_l is None or _is_full_layer(cfg, i):
        return cos, sin
    return cos_l, sin_l


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
    if cfg.qk_norm:
        # per-head RMS (gemma3 stores the weight as w - 1, qwen3 as w)
        q = rms_norm(q, lp["q_norm_w"], cfg.norm_eps, cfg.norm_weight_offset)
        k = rms_norm(k, lp["k_norm_w"], cfg.norm_eps, cfg.norm_weight_offset)
    return (apply_rope(q, cos, sin, cfg.rotary_dim),
            apply_rope(k, cos, sin, cfg.rotary_dim), v)


# the token count up to which an "auto" MoE layer runs the batched
# ("einsum") form; the loop over experts ("scan") above it
MOE_EINSUM_MAX_TOKENS = 256


def _moe_route(cfg: ModelConfig, lp, xf):
    """The router of :func:`_moe_gates`: (top-k gates [N, k] f32, their
    experts [N, k]). Router logits are summed in f32 from the operands as
    they are (``_mm_f32``): a logit rounded to bf16 would flip top-k
    choices at near-ties. With ``moe_renorm`` (mixtral, qwen3moe) the
    softmax runs over the selected logits; without it (qwen2moe) the
    top-k of the full softmax are kept as they are."""
    logits = _mm_f32(xf, lp["router"])                      # [N, E] f32
    if cfg.moe_renorm:
        topw, topi = torch.topk(logits, cfg.n_experts_used, dim=-1)
        return torch.softmax(topw, dim=-1), topi
    return torch.topk(torch.softmax(logits, dim=-1), cfg.n_experts_used,
                      dim=-1)


def _moe_gates(cfg: ModelConfig, lp, xf):
    """xf [N, D] → the top-k gates scattered into a dense [N, E] f32
    matrix (exactly 0 for the experts a token did not select), as the JAX
    package's ``_moe_gates``."""
    topw, topi = _moe_route(cfg, lp, xf)
    gates = torch.zeros((xf.shape[0], cfg.n_experts), dtype=torch.float32,
                        device=xf.device)
    return gates.scatter_(1, topi, topw)


def _moe_scan(cfg: ModelConfig, lp, xf, topw, topi):
    """The "scan" form: a loop over the experts with an [n_e, F] working
    set, each expert computed for the n_e tokens routed to it only (an
    unselected gate is exactly 0, so the other tokens add nothing) and
    added in expert order, as the JAX scan adds every expert in turn. One
    host sync a layer (the tokens per expert)."""
    N, k = topi.shape
    flat = topi.reshape(-1)
    order = torch.argsort(flat, stable=True)
    counts = torch.bincount(flat, minlength=cfg.n_experts).tolist()
    rows, gate = order // k, topw.reshape(-1)[order]
    y = torch.zeros((N, xf.shape[1]), dtype=torch.float32, device=xf.device)
    start = 0
    for e, n in enumerate(counts):
        if not n:
            continue
        t = rows[start:start + n]
        xe = xf[t]
        he = _act(cfg, xe @ lp["we_gate"][e]) * (xe @ lp["we_up"][e])
        y.index_add_(0, t, gate[start:start + n, None]
                     * (he @ lp["we_down"][e]).float())
        start += n
    return y


def _moe_mlp(cfg: ModelConfig, lp, x):
    """Sparse mixture-of-experts gated MLP, exact (no token dropped), with
    the JAX package's ``_moe_mlp``'s points of rounding: each expert's
    ``act(x @ we_gate) * (x @ we_up) @ we_down`` in the weights' dtype,
    widened to f32 and weighted by its gate in f32; qwen2moe's shared
    expert widened to f32 and scaled by the f32 sigmoid of ``x @
    sh_gate``; the sum narrowed to x's dtype once.

    "einsum" (``moe_impl``; "auto" up to ``MOE_EINSUM_MAX_TOKENS`` tokens:
    decode and chunked pieces): every expert over every token, batched
    over the stacked experts, then each token's top-k outputs gathered
    and weighted (the other gates are 0). "scan" (above it):
    :func:`_moe_scan`. The experts are plain PyTorch matmuls: the JAX
    package runs them outside any Pallas kernel."""
    B, T, D = x.shape
    N = B * T
    xf = x.reshape(N, D)
    topw, topi = _moe_route(cfg, lp, xf)
    impl = cfg.moe_impl
    if impl == "auto":
        impl = "einsum" if N <= MOE_EINSUM_MAX_TOKENS else "scan"
    if impl == "einsum":
        h = torch.matmul(xf, lp["we_gate"])                 # [E, N, F]
        u = torch.matmul(xf, lp["we_up"])
        o = torch.matmul(_act(cfg, h) * u, lp["we_down"])   # [E, N, D]
        sel = o[topi, torch.arange(N, device=x.device)[:, None]]
        y = (topw[..., None] * sel.float()).sum(1)          # [N, D] f32
    else:
        y = _moe_scan(cfg, lp, xf, topw, topi)
    if "we_sh_gate" in lp:
        # qwen2moe's shared expert: every token, scaled by its own gate
        hs = _act(cfg, xf @ lp["we_sh_gate"]) * (xf @ lp["we_sh_up"])
        sg = torch.sigmoid((xf @ lp["sh_gate"]).float())   # [N, 1]
        y = y + sg * (hs @ lp["we_sh_down"]).float()
    return y.to(x.dtype).reshape(B, T, D)


def _mlp(cfg: ModelConfig, lp, x):
    if cfg.n_experts:
        return _moe_mlp(cfg, lp, x)
    if cfg.mlp_type == "gated":
        g = _act(cfg, Q.matmul(x, lp["w_gate"]))
        u = Q.matmul(x, lp["w_up"])
        return Q.matmul(g * u, lp["w_down"])
    u = Q.matmul(x, lp["w_up"])
    if "b_up" in lp:
        u = u + lp["b_up"]
    d = Q.matmul(_act(cfg, u), lp["w_down"])
    if "b_down" in lp:
        d = d + lp["b_down"]
    return d


def _proj_out(cfg: ModelConfig, lp, attn):
    """attn [B, T, H, hd] → the output projection [B, T, D] (+ bo)."""
    B, T = attn.shape[:2]
    o = Q.matmul(attn.reshape(B, T, -1), lp["wo"])
    if "bo" in lp:
        o = o + lp["bo"]
    return o


def _residual(cfg: ModelConfig, lp, x, h, attn):
    """The block's residual adds after attention: ``h`` the attention
    input (normed x), which a parallel block's MLP reads too; sandwich
    norms (post_norms) norm the attention and MLP outputs before their
    adds."""
    rm = cfg.residual_multiplier or 1.0
    if cfg.post_norms:
        attn = _norm(cfg, attn, lp["post_attn_norm_w"])
    if cfg.parallel_block:
        return x + attn + _mlp(cfg, lp, h)
    x = x + rm * attn
    m = _mlp(cfg, lp, _norm(cfg, x, lp["mlp_norm_w"], lp.get("mlp_norm_b")))
    if cfg.post_norms:
        m = _norm(cfg, m, lp["post_ffw_norm_w"])
    return x + rm * m


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
    """Final norm + LM head (+ its bias) → f32 logits."""
    x = _norm(cfg, x, params["out_norm_w"], params.get("out_norm_b"))
    if not cfg.tie_embeddings and Q.is_quantized(params["lm_head"]):
        logits = Q.matmul(x, params["lm_head"], out_dtype=torch.float32)
    else:
        head = (params["tok_emb"].t() if cfg.tie_embeddings
                else params["lm_head"])
        logits = _mm_f32(x, head)
    if "lm_head_b" in params:
        logits = logits + params["lm_head_b"].float()
    if cfg.logit_scale:
        logits = logits / cfg.logit_scale
    if cfg.logit_softcap:
        logits = cfg.logit_softcap * torch.tanh(logits / cfg.logit_softcap)
    return logits


# --------------------------------------------------------------------------
# forward passes
# --------------------------------------------------------------------------

def prefill_hidden(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                   inputs_embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The layers of :func:`prefill_chunk` without the LM head: returns
    (hidden [B, T, D], k [L, B, KvH, T, hd], v [...]). The engine
    unembeds only the row it samples from. ``inputs_embeds`` [B, T, D]
    (a multimodal prompt's spliced embeddings) replaces the embedding
    lookup, cast to ``tok_emb``'s dtype; ``tokens`` then only gives the
    shape and is never looked up."""
    B, T = tokens.shape
    scale = _attn_scale(cfg)
    positions = torch.arange(T, device=tokens.device).expand(B, T)
    rope = _rope_pair(positions, cfg)
    if cfg.altern_sliding:
        # each layer's window rides its mask (the JAX package's einsum)
        masks = {w: causal_mask(T, T, 0, w, device=tokens.device)
                 for w in {_layer_window(cfg, i)
                           for i in range(cfg.n_layers)}}
    x = (_embed(cfg, params, tokens) if inputs_embeds is None
         else inputs_embeds.to(params["tok_emb"].dtype))
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _norm(cfg, x, lp["attn_norm_w"], lp.get("attn_norm_b"))
        q, k, v = _qkv(cfg, lp, h, *_layer_rope(cfg, i, rope))
        k = k.transpose(1, 2)                          # [B, KvH, T, hd]
        v = v.transpose(1, 2)
        if cfg.altern_sliding:
            attn = attend_hf(q, k, v, masks[_layer_window(cfg, i)], scale,
                             cfg.attn_softcap)
        else:
            attn = chunk_attention(cfg, q, k, v, scale)
        x = _residual(cfg, lp, x, h, _proj_out(cfg, lp, attn))
        ks.append(k)
        vs.append(v)
    return x, torch.stack(ks), torch.stack(vs)


def embed_forward(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  n_valid: torch.Tensor) -> torch.Tensor:
    """Mean-pooled final hidden states (the JAX ``LoadedModel.embed``
    body): tokens [B, T] right-padded, n_valid [B] → [B, D] f32.

    The layers of :func:`prefill_hidden` with no K/V kept (nobody reads
    them), then the final norm. As in the JAX body, every layer takes one
    mask (causal, within ``cfg.sliding_window``) and the global rope, the
    alternating archs included: their attention goes through the masked
    einsum, every other arch's through the flash-prefill kernel; the
    projections through the quantized matmuls, the experts through
    :func:`_moe_mlp`. The pooling rounds where XLA rounds the JAX body's
    bf16 pooling (which widens bf16 arithmetic to f32 and drops the
    f32 → bf16 → f32 round trips between elementwise steps): the normed
    rows, the masked sum and the valid count each in x's dtype (a bf16
    count of 257..512 rows rounds to even), the division in f32."""
    B, T = tokens.shape
    dev = tokens.device
    scale = _attn_scale(cfg)
    positions = torch.arange(T, device=dev).expand(B, T)
    cos, sin = rope_angles_cfg(positions, cfg)
    if cfg.altern_sliding:
        mask = causal_mask(T, T, 0, cfg.sliding_window, device=dev)
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _norm(cfg, x, lp["attn_norm_w"], lp.get("attn_norm_b"))
        q, k, v = _qkv(cfg, lp, h, cos, sin)
        k = k.transpose(1, 2)                          # [B, KvH, T, hd]
        v = v.transpose(1, 2)
        if cfg.altern_sliding:
            attn = attend_hf(q, k, v, mask, scale, cfg.attn_softcap)
        else:
            attn = chunk_attention(cfg, q, k, v, scale)
        x = _residual(cfg, lp, x, h, _proj_out(cfg, lp, attn))
    x = _norm(cfg, x, params["out_norm_w"], params.get("out_norm_b"))
    valid = (torch.arange(T, device=dev)[None, :]
             < n_valid[:, None]).to(x.dtype)
    total = (x * valid[:, :, None]).sum(1)
    count = torch.clamp(valid.sum(1, keepdim=True), min=1)
    return total.float() / count.float()


def prefill_chunk(params: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  inputs_embeds: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A fresh chunk at positions [0, T) with no prior cache.

    tokens [B, T] (right-padded; callers read logits at n_valid-1);
    ``inputs_embeds`` [B, T, D] replaces their embedding lookup.
    Returns (logits [B, T, V] f32, k [L, B, KvH, T, hd], v [...]), K/V
    head-first like the cache."""
    x, ks, vs = prefill_hidden(params, cfg, tokens, inputs_embeds)
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
    # T > 1 and alternating archs attend the first attn_blocks pages
    # through the gather + einsum, under each layer's window
    gather = T > 1 or cfg.altern_sliding
    if gather:
        masks = {w: _window_mask(positions, attn_blocks * ps, w)
                 for w in {_layer_window(cfg, i)
                           for i in range(cfg.n_layers)}}
        tbl = tables[:, :attn_blocks].long()
    rope = _rope_pair(positions, cfg)
    NBLK = tables.shape[1]
    blk = positions // ps
    pg_w = torch.where(blk < NBLK,
                       tables.long().gather(1, blk.clamp(max=NBLK - 1)),
                       torch.full_like(blk, TRASH_PAGE))
    off_w = positions % ps
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _norm(cfg, x, lp["attn_norm_w"], lp.get("attn_norm_b"))
        q, k, v = _qkv(cfg, lp, h, *_layer_rope(cfg, i, rope))
        _scatter_kv_pools(k_pool, v_pool, i, k.transpose(1, 2),
                          v.transpose(1, 2), pg_w, off_w)
        if gather:
            attn = _paged_gather_attend(cfg, q, k_pool, v_pool, i, tbl,
                                        masks[_layer_window(cfg, i)], scale)
        else:
            attn = paged_decode_attention(
                q, k_pool, v_pool, i, tables, lengths, scale,
                cfg.attn_softcap, cfg.sliding_window, nblk=attn_blocks)
        x = _residual(cfg, lp, x, h, _proj_out(cfg, lp, attn))
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
    rope = _rope_pair(positions, cfg)
    masks = {w: _window_mask(positions, A, w)               # [B, 1, T, A]
             for w in {_layer_window(cfg, i) for i in range(cfg.n_layers)}}
    bx = torch.arange(B, device=dev)[:, None, None]
    hx = torch.arange(KvH, device=dev)[None, :, None]
    pos_w = positions.clamp(max=S - 1)[:, None, :]          # [B, 1, T]
    keep = (positions < S)[:, None, :]
    x = _embed(cfg, params, tokens)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = _norm(cfg, x, lp["attn_norm_w"], lp.get("attn_norm_b"))
        q, k, v = _qkv(cfg, lp, h, *_layer_rope(cfg, i, rope))
        k = k.transpose(1, 2)                              # [B, KvH, T, hd]
        v = v.transpose(1, 2)
        mask = masks[_layer_window(cfg, i)]
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
            if cfg.altern_sliding:
                # the layer's window rides the mask (the JAX package's
                # einsum): no decode kernel
                attn = attend_hf(q, k_cache[i, :, :, :A],
                                 v_cache[i, :, :, :A], mask, scale,
                                 cfg.attn_softcap)
            else:
                attn = cached_attention(cfg, q, k_cache[i], v_cache[i],
                                        mask, q_pos, scale, attn_len=A)
        x = _residual(cfg, lp, x, h, _proj_out(cfg, lp, attn))
    return (x if hidden else _unembed(cfg, params, x)), k_cache, v_cache
