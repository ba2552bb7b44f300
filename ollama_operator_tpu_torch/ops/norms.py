"""Normalisation (f32 accumulation, output in the input's dtype).

Counterpart of ``ollama_operator_tpu/ops/norms.py``. No kernel: on the
card these are a few elementwise launches beside the int4 matmuls.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             weight_offset: float = 0.0) -> torch.Tensor:
    """RMSNorm with f32 accumulation; ``weight_offset=1.0`` is gemma's
    convention of storing the scale as (w - 1)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    y = y * (weight_offset + weight.float())
    return y.to(x.dtype)
