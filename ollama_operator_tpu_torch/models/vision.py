"""CLIP-style vision tower + multimodal projector (the llava family).

Counterpart of ``ollama_operator_tpu/models/vision.py``: a pre-LN ViT
whose 14×14 stride-14 patch "convolution" is a reshape and one matmul,
with a class token and learned position embeddings, then the llava MLP
projector ``mm_0 · GELU · mm_2`` into the decoder's embedding width.

- 3×336×336 input, CLIP normalisation, 14-px patches → 24×24 = 576 tokens;
- features from layer ``n_layers + select_layer + 1`` when
  ``select_layer`` < 0: the penultimate layer (-2) for the presets, every
  layer (-1) for a GGUF-loaded tower, whose converter already dropped the
  last one; the class token is dropped;
- attention scores in f32 with p cast to the value dtype, the exact (erf)
  GELU.

As in the JAX package the tower runs no Pallas kernel, so its products are
plain PyTorch. Like the JAX function, which promotes its f32 pixels
against bf16 weights, the activations stay f32 whatever dtype the weights
are held in (bf16 on the card, f32 on the CPU): each product widens its
weight (exact) and sums in f32.

Params tree (layer leaves stacked on a leading axis, like the decoder's):

  patch_emb [P*P*3, W]  (pixel order (c, i, j) flattened)
  class_emb [W]
  pos_emb   [n_pos, W]          (n_pos = 1 + n_patches)
  pre_ln_w/b [W]
  layers/
    ln1_w/b [L, W]   wq/wk/wv/wo [L, W, W]   bq/bk/bv/bo [L, W]
    ln2_w/b [L, W]   w_up [L, W, F]  b_up [L, F]
                     w_down [L, F, W]  b_down [L, W]
  mm_0 [W, D]  mm_0_b [D]  mm_2 [D, D]  mm_2_b [D]   (projector)
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

Params = Dict[str, Any]

# CLIP preprocessing constants (openai/clip-vit-large-patch14-336)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    """Static ViT description (CLIP ViT-L/14-336's widths by default)."""

    image_size: int = 336
    patch_size: int = 14
    width: int = 1024          # vision hidden size
    n_layers: int = 24         # CLIP's 24; the penultimate feeds llava
    n_heads: int = 16
    ffn_dim: int = 4096
    norm_eps: float = 1e-5
    proj_dim: int = 4096       # the LLM's embedding width (llava-7b: 4096)
    select_layer: int = -2     # penultimate-layer features (llava default)

    @property
    def n_patches_side(self) -> int:
        return self.image_size // self.patch_size

    @property
    def n_patches(self) -> int:
        return self.n_patches_side ** 2

    @property
    def head_dim(self) -> int:
        return self.width // self.n_heads

    @property
    def n_run(self) -> int:
        """Transformer layers the features come out of."""
        return (self.n_layers + self.select_layer + 1
                if self.select_layer < 0 else self.select_layer)

    @property
    def n_params(self) -> int:
        W, Fd, D, P = self.width, self.ffn_dim, self.proj_dim, self.patch_size
        per_layer = 4 * W * W + 2 * W * Fd + 9 * W + Fd
        return (3 * P * P * W + (2 + self.n_patches) * W + 2 * W
                + self.n_layers * per_layer + W * D + D * D + 2 * D)

    def validate(self) -> "VisionConfig":
        assert self.image_size % self.patch_size == 0
        assert self.width % self.n_heads == 0
        return self


TINY_VISION = VisionConfig(image_size=16, patch_size=8, width=32, n_layers=3,
                           n_heads=4, ffn_dim=64, proj_dim=64)


def init_params(cfg: VisionConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """Random weights with the JAX package's distributions (normal with
    std 0.02 for the matrices and the class and position embeddings, ones
    for the norm weights, zeros for the biases); the bits differ, since
    the generators differ. On the card unless the caller names the CPU;
    ``generator`` must live on ``device``."""
    device = resolve_device(device)
    L, W, Fd, D, P = (cfg.n_layers, cfg.width, cfg.ffn_dim, cfg.proj_dim,
                      cfg.patch_size)

    def w(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers = {
        "ln1_w": const(1, L, W), "ln1_b": const(0, L, W),
        "ln2_w": const(1, L, W), "ln2_b": const(0, L, W),
        "wq": w(L, W, W), "bq": const(0, L, W),
        "wk": w(L, W, W), "bk": const(0, L, W),
        "wv": w(L, W, W), "bv": const(0, L, W),
        "wo": w(L, W, W), "bo": const(0, L, W),
        "w_up": w(L, W, Fd), "b_up": const(0, L, Fd),
        "w_down": w(L, Fd, W), "b_down": const(0, L, W),
    }
    return {
        "patch_emb": w(P * P * 3, W),
        "class_emb": w(W),
        "pos_emb": w(1 + cfg.n_patches, W),
        "pre_ln_w": const(1, W), "pre_ln_b": const(0, W),
        "layers": layers,
        "mm_0": w(W, D), "mm_0_b": const(0, D),
        "mm_2": w(D, D), "mm_2_b": const(0, D),
    }


def _ln(x, w, b, eps: float):
    m = x.mean(dim=-1, keepdim=True)
    v = (x - m).square().mean(dim=-1, keepdim=True)
    return (x - m) / torch.sqrt(v + eps) * w.to(x.dtype) + b.to(x.dtype)


def _lin(x, w, b):
    """x @ w + b in x's dtype (the weight widened, exactly)."""
    return x @ w.to(x.dtype) + b.to(x.dtype)


def patchify(cfg: VisionConfig, images: torch.Tensor) -> torch.Tensor:
    """images [B, H, W, 3] → patch pixels [B, N, P*P*3] in (c, i, j)
    order: the P×P stride-P convolution is then one matmul."""
    B = images.shape[0]
    P, n = cfg.patch_size, cfg.n_patches_side
    x = images.reshape(B, n, P, n, P, 3)
    x = x.permute(0, 1, 3, 5, 2, 4)              # [B, n, n, C, P, P]
    return x.reshape(B, n * n, 3 * P * P)


def encode(cfg: VisionConfig, params: Params, images: torch.Tensor
           ) -> torch.Tensor:
    """images [B, H, W, 3] (CLIP-normalised f32) → [B, n_patches, D]
    projected image tokens in the decoder's embedding space, f32."""
    B = images.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    eps = cfg.norm_eps
    scale = 1.0 / math.sqrt(hd)
    images = images.float()
    x = patchify(cfg, images) @ params["patch_emb"].float()   # [B, N, W]
    cls = params["class_emb"].float().expand(B, 1, cfg.width)
    x = torch.cat([cls, x], dim=1)                          # [B, 1+N, W]
    x = x + params["pos_emb"][None, :x.shape[1]].float()
    x = _ln(x, params["pre_ln_w"], params["pre_ln_b"], eps)
    T = x.shape[1]
    layers = params["layers"]
    for i in range(cfg.n_run):
        lp = {k: v[i] for k, v in layers.items()}
        h = _ln(x, lp["ln1_w"], lp["ln1_b"], eps)
        q = _lin(h, lp["wq"], lp["bq"]).reshape(B, T, H, hd)
        k = _lin(h, lp["wk"], lp["bk"]).reshape(B, T, H, hd)
        v = _lin(h, lp["wv"], lp["bv"]).reshape(B, T, H, hd)
        s = torch.einsum("bthd,bshd->bhts", q.float(), k.float()) * scale
        p = torch.softmax(s, dim=-1).to(v.dtype)
        a = torch.einsum("bhts,bshd->bthd", p, v).reshape(B, T, cfg.width)
        x = x + _lin(a, lp["wo"], lp["bo"])
        h2 = _ln(x, lp["ln2_w"], lp["ln2_b"], eps)
        m = F.gelu(_lin(h2, lp["w_up"], lp["b_up"]), approximate="none")
        x = x + _lin(m, lp["w_down"], lp["b_down"])
    feats = x[:, 1:]                                        # drop the class
    h = F.gelu(_lin(feats, params["mm_0"], params["mm_0_b"]),
               approximate="none")
    return _lin(h, params["mm_2"], params["mm_2_b"])        # [B, N, D]
