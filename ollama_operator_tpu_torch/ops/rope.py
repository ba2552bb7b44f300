"""Rotary position embeddings with context-extension scaling.

Counterpart of ``ollama_operator_tpu/ops/rope.py``: the same half-split
(NeoX/HF) layout, and every scaling scheme reduced to a static
per-frequency rescale of ``inv_freq`` computed in numpy
(:func:`scaled_inv_freq` is a copy of the JAX package's).
"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def scaled_inv_freq(rotary_dim: int, theta: float, *,
                    scaling_type: str = "none", factor: float = 1.0,
                    orig_ctx: int = 0, low_freq_factor: float = 1.0,
                    high_freq_factor: float = 4.0, attn_factor: float = 0.0,
                    beta_fast: float = 32.0, beta_slow: float = 1.0,
                    freq_factors: Optional[Tuple[float, ...]] = None,
                    ) -> Tuple[Tuple[float, ...], float]:
    """Per-frequency rotation rates after context-extension scaling.

    Returns ``(inv_freq, mscale)``: ``inv_freq`` a length rotary_dim//2
    tuple of f32 rates, ``mscale`` the scalar YaRN multiplies cos/sin by
    (1.0 for every other scheme). Schemes: ``none`` (a factor != 1 acts
    as linear), ``linear``, ``yarn`` (NTK-by-parts), ``llama3``
    (low/high-frequency interpolation band), and ``freq_factors`` from a
    GGUF ``rope_freqs`` tensor, which replaces the metadata scheme.
    """
    half = rotary_dim // 2
    inv_freq = 1.0 / (theta ** (np.arange(half, dtype=np.float64) / half))
    mscale = 1.0

    if freq_factors is not None:
        ff = np.asarray(freq_factors, dtype=np.float64)
        assert ff.shape == (half,), (
            f"rope_freq_factors has {ff.shape[0]} entries; rotary_dim "
            f"{rotary_dim} needs {half}")
        inv_freq = inv_freq / ff
        if attn_factor > 0:
            mscale = attn_factor
    elif scaling_type == "linear" or (scaling_type == "none"
                                      and factor != 1.0):
        inv_freq = inv_freq / factor
    elif scaling_type == "llama3":
        assert orig_ctx > 0, "llama3 rope scaling needs rope_orig_ctx"
        low_wavelen = orig_ctx / low_freq_factor
        high_wavelen = orig_ctx / high_freq_factor
        wavelen = 2.0 * math.pi / inv_freq
        scaled = np.where(wavelen > low_wavelen, inv_freq / factor, inv_freq)
        smooth = ((orig_ctx / wavelen - low_freq_factor)
                  / (high_freq_factor - low_freq_factor))
        blended = (1.0 - smooth) * scaled / factor + smooth * scaled
        medium = (wavelen >= high_wavelen) & (wavelen <= low_wavelen)
        inv_freq = np.where(medium, blended, scaled)
    elif scaling_type == "yarn":
        assert orig_ctx > 0, "yarn rope scaling needs rope_orig_ctx"

        def correction_dim(n_rot: float) -> float:
            return (rotary_dim
                    * math.log(orig_ctx / (n_rot * 2.0 * math.pi))
                    / (2.0 * math.log(theta)))

        low = max(math.floor(correction_dim(beta_fast)), 0)
        high = min(math.ceil(correction_dim(beta_slow)), rotary_dim - 1)
        if low == high:
            high = low + 0.001  # avoid a 0-width ramp
        ramp = np.clip((np.arange(half, dtype=np.float64) - low)
                       / (high - low), 0.0, 1.0)
        extrap = 1.0 - ramp
        inv_freq = (inv_freq / factor) * (1.0 - extrap) + inv_freq * extrap
        mscale = attn_factor if attn_factor > 0 else (
            0.1 * math.log(factor) + 1.0 if factor > 1.0 else 1.0)
    elif scaling_type != "none":
        raise ValueError(f"unknown rope scaling type {scaling_type!r}")

    return tuple(np.asarray(inv_freq, np.float32).tolist()), float(mscale)


def rope_angles_cfg(positions: torch.Tensor, cfg
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions [..] int → (cos, sin) [.., rotary_dim//2] f32 on the
    positions' device, with the model's full scaling scheme applied."""
    inv_freq, mscale = scaled_inv_freq(
        cfg.rotary_dim, cfg.rope_theta,
        scaling_type=cfg.rope_scaling_type, factor=cfg.rope_scaling,
        orig_ctx=cfg.rope_orig_ctx,
        low_freq_factor=cfg.rope_low_freq_factor,
        high_freq_factor=cfg.rope_high_freq_factor,
        attn_factor=cfg.rope_attn_factor,
        beta_fast=cfg.rope_yarn_beta_fast,
        beta_slow=cfg.rope_yarn_beta_slow,
        freq_factors=cfg.rope_freq_factors)
    inv = torch.tensor(inv_freq, dtype=torch.float32,
                       device=positions.device)
    angles = positions.float()[..., None] * inv
    cos, sin = torch.cos(angles), torch.sin(angles)
    if mscale != 1.0:
        cos, sin = cos * mscale, sin * mscale
    return cos, sin


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               rotary_dim: int) -> torch.Tensor:
    """x [B, T, H, head_dim]; cos/sin [B, T, rotary_dim//2]. Rotates the
    first ``rotary_dim`` channels (half-split) in f32, passes the rest
    through unchanged."""
    half = rotary_dim // 2
    x_rot = x[..., :rotary_dim].float()
    x1, x2 = x_rot[..., :half], x_rot[..., half:]
    c = cos[:, :, None, :]
    s = sin[:, :, None, :]
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)
    if rotary_dim == x.shape[-1]:
        return out
    return torch.cat([out, x[..., rotary_dim:]], dim=-1)
