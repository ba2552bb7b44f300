"""Attention cores and the wrappers of the flash-prefill and dense-cache
decode kernels.

Counterpart of ``ollama_operator_tpu/ops/attention.py`` (``attend_hf``,
``causal_mask``, ``softcap_scores``, ``chunk_attention``,
``cached_attention``) and of the Pallas ``flash_prefill``,
``decode_attention`` and ``mha_decode_attention`` in
``ops/pallas/flash.py``. GQA is a grouped einsum over head-first K/V
([B, KvH, S, hd]); K/V are never repeated.

:func:`flash_prefill` launches ``csrc/flash_prefill.cu`` and
:func:`decode_attention` / :func:`mha_decode_attention` launch the two
entries of ``csrc/decode_attention.cu`` for tensors on the card; for
tensors on the CPU each runs its plain PyTorch version
(:func:`flash_prefill_plain`, :func:`decode_attention_plain`,
:func:`mha_decode_attention_plain`).
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import cuda_build

NEG_INF = -1e30  # large-negative, not -inf: masked softmax stays NaN-free


def softcap_scores(scores: torch.Tensor, cap: float) -> torch.Tensor:
    """Gemma2-style tanh soft-capping (no-op when cap <= 0)."""
    if cap and cap > 0.0:
        return cap * torch.tanh(scores / cap)
    return scores


def attend_hf(q, k, v, mask, scale: float, softcap: float = 0.0):
    """Grouped-query attention with head-first K/V.

    q [B, T, H, hd]; k, v [B, KvH, S, hd]; mask [B, 1, T, S] additive
    (0 or NEG_INF), broadcastable → [B, T, H, hd] (q.dtype). Scores and
    softmax in f32; the probabilities are rounded to v's dtype before the
    p . v product, as the JAX package's ``attend_hf`` does."""
    B, T, H, hd = q.shape
    KvH = k.shape[1]
    G = H // KvH
    qg = q.reshape(B, T, KvH, G, hd)
    scores = torch.einsum("btkgh,bksh->bkgts", qg.float(), k.float())
    scores = softcap_scores(scores * scale, softcap)
    scores = scores + mask[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1).to(v.dtype).float()
    out = torch.einsum("bkgts,bksh->btkgh", probs, v.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


def causal_mask(T: int, S: int, offset: int, sliding_window: int = 0,
                device=None) -> torch.Tensor:
    """Additive [1, 1, T, S] f32 mask: query i sits at absolute position
    offset + i, key j at j; keys j <= i (within ``sliding_window``)."""
    q_pos = offset + torch.arange(T, device=device)[:, None]
    k_pos = torch.arange(S, device=device)[None, :]
    ok = k_pos <= q_pos
    if sliding_window:
        ok = ok & (k_pos > q_pos - sliding_window)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(ok, zero, NEG_INF)[None, None]


def _softmax_pv(s, ok, v, round_p: bool):
    """The TPU kernels' softmax and p . v: s [B, KvH, G, T, S] f32 scores
    (scaled, soft-capped), ok (broadcastable to s) the live keys, v [B,
    KvH, S, hd] → [B, KvH, G, T, hd] f32. p = exp(s - row max) with masked
    keys at NEG_INF (a row with no live key gives 0); with ``round_p`` p is
    rounded to v's dtype before the p . v product, while the sum l takes
    the unrounded p; out = (p . v) / max(l, 1e-30)."""
    s = torch.where(ok, s, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    zero = torch.zeros((), dtype=torch.float32, device=s.device)
    p = torch.where(m > NEG_INF / 2, torch.exp(s - m), zero)
    l = p.sum(dim=-1, keepdim=True)
    if round_p:
        p = p.to(v.dtype).float()
    out = torch.einsum("bkgts,bksh->bkgth", p, v.float())
    return out / torch.clamp(l, min=1e-30)


def flash_prefill_plain(q, k, v, scale: float, softcap: float = 0.0,
                        sliding_window: int = 0):
    """Plain version of the flash-prefill kernel: causal (optionally
    windowed) GQA self-attention over a fresh chunk, positions local to
    the chunk. q [B, T, H, hd], k/v [B, KvH, T, hd] → [B, T, H, hd]. The
    probabilities are taken from the row max and rounded to v's dtype
    before the p . v product, as the TPU kernel does over a chunk that
    fits one key block (the CUDA kernel rounds them per 64-key tile, from
    the running max)."""
    B, T, H, hd = q.shape
    KvH = k.shape[1]
    qg = q.reshape(B, T, KvH, H // KvH, hd).float()
    s = torch.einsum("btkgh,bksh->bkgts", qg, k.float()) * scale
    s = softcap_scores(s, softcap)
    ok = causal_mask(T, T, 0, sliding_window, device=q.device) == 0
    out = _softmax_pv(s, ok[:, :, None], v, round_p=True)
    return out.permute(0, 3, 1, 2, 4).reshape(B, T, H, hd).to(q.dtype)


def flash_prefill(q, k, v, scale: float, softcap: float = 0.0,
                  sliding_window: int = 0):
    """Causal GQA self-attention over a fresh chunk (positions [0, T)).

    q [B, T, H, hd], k/v head-first [B, KvH, T, hd] → [B, T, H, hd]. On
    the card this launches ``csrc/flash_prefill.cu`` (bf16, hd a multiple
    of 16 up to 128) and raises on anything it does not take; on the CPU
    it runs :func:`flash_prefill_plain`."""
    if not cuda_build.on_card(q, k, v):
        return flash_prefill_plain(q, k, v, scale, softcap, sliding_window)
    B, T, H, hd = q.shape
    KvH = k.shape[1]
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash_prefill kernel takes bf16, got {q.dtype}")
    if k.shape != (B, KvH, T, hd) or v.shape != k.shape:
        raise ValueError(f"k/v shape {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)}")
    # hd a multiple of 16 up to 128: the TPU kernel's own rule
    if T < 1 or H % KvH or hd % 16 or hd > 128:
        raise ValueError(f"flash_prefill kernel: T={T} H={H} KvH={KvH} "
                         f"hd={hd} unsupported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_prefill kernel: operands must be 16-byte "
                         "aligned")
    out = torch.empty_like(q)
    fn = cuda_build.function(
        "flash_prefill", "flash_prefill_bf16",
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, T, H, KvH, hd, float(scale), float(softcap or 0.0),
            int(sliding_window), torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, "flash_prefill")
    cuda_build.launches["flash_prefill"] += 1
    return out


def chunk_attention(cfg, q, k, v, scale: float):
    """Prefill attention over a fresh chunk: the flash-prefill kernel on
    the card, its plain version on the CPU (chunk-local causal
    semantics). K/V head-first [B, KvH, T, hd]."""
    return flash_prefill(q, k, v, scale, cfg.attn_softcap,
                         cfg.sliding_window)


# --------------------------------------------------------------------------
# decode against the dense head-first slot cache
# --------------------------------------------------------------------------

def _decode_plain(q, k_cache, v_cache, q_pos, scale: float, softcap: float,
                  sliding_window: int, round_p: bool):
    """One query row per head against cache rows j <= q_pos[b] (and
    j > q_pos[b] - sliding_window): f32 scores, scaled then soft-capped,
    a softmax from the row max with NEG_INF for masked keys (a row with no
    live key gives 0), and out = (p . v) / max(sum p, 1e-30). With
    ``round_p`` the probabilities are rounded to the cache dtype before
    the p . v product, as the TPU's GQA decode kernel does."""
    B, _, H, hd = q.shape
    KvH, S = k_cache.shape[1], k_cache.shape[2]
    qg = q.reshape(B, 1, KvH, H // KvH, hd).float()
    s = torch.einsum("btkgh,bksh->bkgts", qg, k_cache.float()) * scale
    s = softcap_scores(s, softcap)
    k_pos = torch.arange(S, device=q.device)[None, :]
    qp = q_pos.long()[:, None]
    ok = k_pos <= qp
    if sliding_window:
        ok = ok & (k_pos > qp - sliding_window)
    out = _softmax_pv(s, ok[:, None, None, None, :], v_cache, round_p)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def decode_attention_plain(q, k_cache, v_cache, q_pos, scale: float,
                           softcap: float = 0.0, sliding_window: int = 0):
    """Plain version of the GQA decode kernel (the TPU's
    ``decode_attention``): q [B, 1, H, hd]; k/v [B, KvH, S, hd]; q_pos
    [B] the query's absolute position → [B, 1, H, hd] (q.dtype)."""
    return _decode_plain(q, k_cache, v_cache, q_pos, scale, softcap,
                         sliding_window, round_p=True)


def mha_decode_attention_plain(q, k_cache, v_cache, q_pos, scale: float,
                               softcap: float = 0.0,
                               sliding_window: int = 0):
    """Plain version of the MHA decode kernel (the TPU's
    ``mha_decode_attention``, KvH == H): as :func:`decode_attention_plain`
    with the probabilities kept in f32."""
    return _decode_plain(q, k_cache, v_cache, q_pos, scale, softcap,
                         sliding_window, round_p=False)


_PTR, _INT, _I64, _FLT = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)

# Cache rows a CTA of the dense decode kernels walks: both split the
# sequence into chunks of this many rows (a positive multiple of their
# 32-row tile) and merge the chunks' partial softmax states in a second
# launch. 256 measured fastest on the H100 for the GQA kernel at the
# serving lengths and within 4% of 512 at the 4096-row slots (PERF.md
# section 6).
DECODE_CHUNK = 256


def decode_chunk_rows(q_pos: int, S: int, window: int, chunk: int):
    """The cache rows each CTA of the split decode kernel attends for a
    query at ``q_pos``: one ``range`` per chunk z of ``ceil(S / chunk)``,
    the live rows [max(0, q_pos - window + 1), min(q_pos, S - 1)] inside
    [z * chunk, (z + 1) * chunk), empty for a chunk past q_pos or before
    the window (as ``csrc/decode_attention.cu`` computes them). The chunk
    count depends on S and ``chunk`` only."""
    lo = max(0, q_pos - window + 1) if window > 0 else 0
    hi = min(q_pos, S - 1)
    return [range(max(lo, z * chunk), min(hi, z * chunk + chunk - 1) + 1)
            for z in range(-(-S // chunk))]


def _decode_launch(mha: bool, q, k_cache, v_cache, q_pos, scale: float,
                   softcap: float, sliding_window: int):
    """Launch one entry of ``csrc/decode_attention.cu``; raises on anything
    it does not take. K/V may be a prefix view of a longer cache (rows of
    hd contiguous elements, each (slot, head) block at its own stride)."""
    B, T, H, hd = q.shape
    _, KvH, S, _ = k_cache.shape
    name = "mha_decode" if mha else "decode_attention"
    if T != 1 or not (q.dtype == k_cache.dtype == v_cache.dtype
                      == torch.bfloat16):
        raise TypeError(f"{name} kernel takes bf16 q [B, 1, H, hd] and a "
                        f"bf16 cache; got {tuple(q.shape)} {q.dtype}, "
                        f"cache {k_cache.dtype}")
    if (k_cache.shape != (B, KvH, S, hd) or v_cache.shape != k_cache.shape
            or H % KvH or H // KvH > 8 or (mha and KvH != H) or hd % 8
            or hd > 256 or S < 1):
        raise ValueError(f"{name} kernel: q {tuple(q.shape)}, cache "
                         f"{tuple(k_cache.shape)} unsupported")
    strides = k_cache.stride()
    if (v_cache.stride() != strides or strides[2:] != (hd, 1)
            or strides[0] % 8 or strides[1] % 8
            or k_cache.data_ptr() % 16 or v_cache.data_ptr() % 16):
        raise ValueError(f"{name} kernel needs rows of hd contiguous "
                         f"elements at 16-byte aligned strides; got "
                         f"strides {strides}")
    if q_pos.dtype != torch.int32 or q_pos.shape != (B,) \
            or not q_pos.is_contiguous():
        raise TypeError("q_pos must be a contiguous int32 [B] tensor")
    chunk = DECODE_CHUNK
    if chunk <= 0 or chunk % 32:
        raise ValueError(f"{name} kernel splits the rows in chunks of a "
                         f"positive multiple of 32; DECODE_CHUNK is {chunk}")
    q = q.contiguous()
    out = torch.empty_like(q)
    # the chunks' partial states in one allocation: acc [runs, KvH, G, hd]
    # then (m, l) [runs, KvH, G, 2], runs = B * chunks
    runs = B * -(-S // chunk)
    part = torch.empty(runs * H * (hd + 2), dtype=torch.float32,
                       device=q.device)
    ml_ptr = part.data_ptr() + 4 * runs * H * hd
    heads = [B, H] if mha else [B, H, KvH]
    fn = cuda_build.function(
        "decode_attention", "mha_decode_bf16" if mha
        else "decode_attention_bf16",
        [_PTR] * 7 + [_INT] * (len(heads) + 2) + [_I64, _I64, _FLT, _FLT,
                                                  _INT, _INT, _PTR])
    rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            q_pos.data_ptr(), out.data_ptr(), part.data_ptr(), ml_ptr,
            *heads, S, hd, strides[0], strides[1],
            float(scale), float(softcap or 0.0), int(sliding_window), chunk,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, name)
    cuda_build.launches[name] += 1
    return out


def decode_attention(q, k_cache, v_cache, q_pos, scale: float,
                     softcap: float = 0.0, sliding_window: int = 0):
    """Single-token GQA attention against the head-first slot cache.

    q [B, 1, H, hd]; k_cache/v_cache [B, KvH, S, hd]; q_pos [B] int32, the
    query's absolute position (its own K/V already written there) → [B, 1,
    H, hd] (q.dtype). On the card this launches the GQA entry of
    ``csrc/decode_attention.cu`` (bf16; H / KvH <= 8, hd % 8 == 0,
    hd <= 256; any S), which splits the rows in chunks of
    ``DECODE_CHUNK``, reads only the live ones and merges the chunks in a
    second launch, and raises on anything it does not take; on the CPU it
    runs :func:`decode_attention_plain`."""
    if not cuda_build.on_card(q, k_cache, v_cache, q_pos):
        return decode_attention_plain(q, k_cache, v_cache, q_pos, scale,
                                      softcap, sliding_window)
    return _decode_launch(False, q, k_cache, v_cache, q_pos, scale,
                          softcap, sliding_window)


def mha_decode_attention(q, k_cache, v_cache, q_pos, scale: float,
                         softcap: float = 0.0, sliding_window: int = 0):
    """:func:`decode_attention` for MHA (KvH == H): on the card the MHA
    entry of ``csrc/decode_attention.cu`` (the TPU's
    ``mha_decode_attention``), on the CPU
    :func:`mha_decode_attention_plain`."""
    if not cuda_build.on_card(q, k_cache, v_cache, q_pos):
        return mha_decode_attention_plain(q, k_cache, v_cache, q_pos, scale,
                                          softcap, sliding_window)
    return _decode_launch(True, q, k_cache, v_cache, q_pos, scale, softcap,
                          sliding_window)


def cached_attention(cfg, q, k_cache, v_cache, mask, q_pos, scale: float,
                     attn_len=None):
    """Attention against one layer's head-first slot cache [B, KvH, S, hd],
    routed as the JAX package's ``cached_attention`` routes it. q_pos
    [B, T] int32 are the new tokens' absolute positions; ``attn_len``
    bounds the attended prefix (a view, no copy). A T=1 step goes to

    - the MHA decode kernel for MHA (KvH == H) when ``TPU_MHA_KERNEL=1``
      (read at call time);
    - the GQA decode kernel for GQA, and for MHA when the config or
      ``OLLAMA_TPU_KERNELS`` asks for ``pallas`` explicitly;
    - the masked einsum (:func:`attend_hf`, mask [B, 1, T, A] additive)
      otherwise, and for T > 1."""
    if attn_len is not None and attn_len < k_cache.shape[2]:
        k_cache = k_cache[:, :, :attn_len]
        v_cache = v_cache[:, :, :attn_len]
    if q.shape[1] == 1:
        is_mha = q.shape[2] == k_cache.shape[1]
        args = (q, k_cache, v_cache, q_pos[:, 0], scale, cfg.attn_softcap,
                cfg.sliding_window)
        if is_mha and os.environ.get("TPU_MHA_KERNEL", "") == "1":
            return mha_decode_attention(*args)
        explicit_pallas = (cfg.kernels == "pallas" or os.environ.get(
            "OLLAMA_TPU_KERNELS") == "pallas")
        if not is_mha or explicit_pallas:
            return decode_attention(*args)
    return attend_hf(q, k_cache, v_cache, mask, scale, cfg.attn_softcap)
