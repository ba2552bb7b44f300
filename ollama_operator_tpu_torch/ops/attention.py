"""Attention cores and the flash-prefill kernel's wrapper.

Counterpart of ``ollama_operator_tpu/ops/attention.py`` (``attend_hf``,
``causal_mask``, ``softcap_scores``, ``chunk_attention``) and of the
Pallas ``flash_prefill`` in ``ops/pallas/flash.py``. GQA is a grouped
einsum over head-first K/V ([B, KvH, S, hd]); K/V are never repeated.

:func:`flash_prefill` launches the CUDA kernel ``csrc/flash_prefill.cu``
for tensors on the card and runs :func:`flash_prefill_plain`, the plain
PyTorch version of the same function, for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

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
    softmax in f32."""
    B, T, H, hd = q.shape
    KvH = k.shape[1]
    G = H // KvH
    qg = q.reshape(B, T, KvH, G, hd)
    scores = torch.einsum("btkgh,bksh->bkgts", qg.float(), k.float())
    scores = softcap_scores(scores * scale, softcap)
    scores = scores + mask[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
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


def flash_prefill_plain(q, k, v, scale: float, softcap: float = 0.0,
                        sliding_window: int = 0):
    """Plain version of the flash-prefill kernel: causal (optionally
    windowed) GQA self-attention over a fresh chunk, positions local to
    the chunk. q [B, T, H, hd], k/v [B, KvH, T, hd] → [B, T, H, hd]."""
    T = q.shape[1]
    mask = causal_mask(T, T, 0, sliding_window, device=q.device)
    return attend_hf(q, k, v, mask, scale, softcap)


def flash_prefill(q, k, v, scale: float, softcap: float = 0.0,
                  sliding_window: int = 0):
    """Causal GQA self-attention over a fresh chunk (positions [0, T)).

    q [B, T, H, hd], k/v head-first [B, KvH, T, hd] → [B, T, H, hd]. On
    the card this launches ``csrc/flash_prefill.cu`` (bf16, hd a multiple
    of 8 up to 128) and raises on anything it does not take; on the CPU
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
    if H % KvH or hd % 8 or hd > 128:
        raise ValueError(f"flash_prefill kernel: H={H} KvH={KvH} hd={hd} "
                         f"unsupported")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
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
