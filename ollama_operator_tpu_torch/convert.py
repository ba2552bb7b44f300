"""Carry a params tree given as numpy arrays into the port's layout.

The JAX package's params tree (``jax.tree_util.tree_map(np.asarray,
params)`` on the caller's side, or a GGUF transcode's numpy tree) maps
one to one onto the port's: the same keys, the same stacked ``[L, ...]``
layer leaves, weights ``[K, O]``, and quantized leaves as ``{"q4", "s"}``
or ``{"q", "s"}`` dicts. The encoder's tree (``models/encoder.py``:
tables, stacked ``[L, ...]`` layer leaves, f32) carries over the same
way. Only the array type changes, so the JAX models and the port compute
on identical weights. bfloat16 leaves come either as
numpy's extension dtype (as JAX hands them out) or as uint16 arrays of
their bit patterns (as the port's GGUF transcode and weight cache hold
them: the port has no bfloat16 numpy type).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from .device import resolve_device


def tensor_from_numpy(a: np.ndarray, device="cuda") -> torch.Tensor:
    """numpy → torch on ``device`` (the card unless the caller names the
    CPU; raises without CUDA), bit for bit. bfloat16 arrays (numpy's
    extension dtype, as JAX hands them out) travel as their 16-bit
    patterns, and uint16 arrays are taken as such patterns."""
    device = resolve_device(device)
    a = np.array(a)   # a private, writable, contiguous copy
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16
                                                       ).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """A (nested dict) params tree of numpy arrays → the same tree of
    torch tensors on ``device`` (the card unless the caller names the
    CPU; raises without CUDA)."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)
