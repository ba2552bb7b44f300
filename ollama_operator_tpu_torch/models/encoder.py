"""BERT-family text encoder (embedding models: all-minilm, bge-*,
mxbai-embed-large, ...) in PyTorch.

Counterpart of ``ollama_operator_tpu/models/encoder.py``. Classic BERT,
post-LayerNorm, in f32 (the JAX server serves encoders in float32):

    x = LN(tok_emb[ids] + pos_emb[0..T) + type_emb[0])
    L x [ x = LN(x + MHA_bidir(x));  x = LN(x + gelu-MLP(x)) ]
    embed = mean over valid tokens (bert.pooling_type 1) or the [CLS]
            row (pooling_type 2)

One forward over a padded [B, T] batch with a [B, T] validity mask:
bidirectional attention with a -1e30 key bias on padded positions, no KV
cache, no scheduler and no decode loop (an embedding model loads as
``runtime/service.EmbeddingModel``, not as an Engine). The gelu is the
exact (erf) one and LayerNorm's eps 1e-12, as in the JAX package.

The JAX package runs this path through einsums and no Pallas kernel, so
the port runs plain PyTorch products here too. On the card they run in
full f32: :func:`forward` turns TF32 off for them and checks that it is
off, since TF32 would keep about three decimal digits of each product.

Weight layout (the llama.cpp conversion, ``gguf/transcode.py``
``load_encoder_params``): tok_emb [V, D], pos_emb [P, D], type_emb
[types, D], emb_norm_w/b [D]; layers/ wq, wk, wv, wo [L, D, D] with
bq, bk, bv, bo [L, D], attn_norm_w/b [L, D], w_up [L, D, F], b_up [L, F],
w_down [L, F, D], b_down [L, D], ffn_norm_w/b [L, D].
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..device import resolve_device

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    vocab_size: int
    dim: int
    n_layers: int
    n_heads: int
    ffn_dim: int
    max_seq_len: int = 512          # learned position table size
    n_token_types: int = 2
    norm_eps: float = 1e-12
    pooling: str = "mean"           # bert.pooling_type 1 = mean, 2 = cls
    arch: str = "bert"

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def n_params(self) -> int:
        D, Fd, L, V = self.dim, self.ffn_dim, self.n_layers, self.vocab_size
        per_layer = 4 * D * D + 2 * D * Fd
        return V * D + self.max_seq_len * D + L * per_layer


def init_params(cfg: EncoderConfig, generator: torch.Generator,
                dtype: torch.dtype = torch.float32, device="cuda") -> Params:
    """Random weights with the JAX package's distributions (normal with
    std 0.02 for matrices and the token and position tables, ones for norm
    weights, zeros for biases and the token-type table); the bits differ,
    since the generators differ. On the card unless the caller names the
    CPU; ``generator`` must live on ``device``."""
    device = resolve_device(device)
    D, Fd, L = cfg.dim, cfg.ffn_dim, cfg.n_layers

    def g(*shape):
        return (torch.randn(shape, generator=generator, dtype=torch.float32,
                            device=device) * 0.02).to(dtype)

    def const(value, *shape):
        return torch.full(shape, value, dtype=dtype, device=device)

    layers = {"wq": g(L, D, D), "wk": g(L, D, D), "wv": g(L, D, D),
              "wo": g(L, D, D), "bq": const(0, L, D), "bk": const(0, L, D),
              "bv": const(0, L, D), "bo": const(0, L, D),
              "attn_norm_w": const(1, L, D), "attn_norm_b": const(0, L, D),
              "w_up": g(L, D, Fd), "b_up": const(0, L, Fd),
              "w_down": g(L, Fd, D), "b_down": const(0, L, D),
              "ffn_norm_w": const(1, L, D), "ffn_norm_b": const(0, L, D)}
    return {"tok_emb": g(cfg.vocab_size, D), "pos_emb": g(cfg.max_seq_len, D),
            "type_emb": const(0, cfg.n_token_types, D),
            "emb_norm_w": const(1, D), "emb_norm_b": const(0, D),
            "layers": layers}


def _ln(x, w, b, eps: float):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w + b


def _exact_f32(device: torch.device):
    """Full-f32 products on the card: TF32 off, and checked off."""
    if device.type != "cuda":
        return
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("TF32 is on for f32 matmuls; the encoder needs "
                           "full f32 products")


def forward(params: Params, cfg: EncoderConfig, tokens: torch.Tensor,
            n_valid: torch.Tensor) -> torch.Tensor:
    """tokens [B, T] (zero-padded), n_valid [B] → pooled embeddings
    [B, D] f32: the mean over each row's valid positions, or its [CLS]
    (first) row with ``cfg.pooling == "cls"``. Runs on the tensors'
    device."""
    B, T = tokens.shape
    H, hd, eps = cfg.n_heads, cfg.head_dim, cfg.norm_eps
    dev = tokens.device
    _exact_f32(dev)
    tokens = tokens.long()
    valid = torch.arange(T, device=dev)[None, :] < n_valid[:, None]  # [B, T]
    x = (params["tok_emb"][tokens] + params["pos_emb"][None, :T, :]
         + params["type_emb"][0][None, None, :])
    x = _ln(x.float(), params["emb_norm_w"], params["emb_norm_b"], eps)
    # every query attends every valid key (bidirectional)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    bias = torch.where(valid[:, None, None, :], zero, -1e30)   # [B,1,1,T]
    scale = 1.0 / math.sqrt(hd)
    layers = params["layers"]
    for i in range(cfg.n_layers):
        lp = {k: v[i] for k, v in layers.items()}
        q = (x @ lp["wq"] + lp["bq"]).reshape(B, T, H, hd)
        k = (x @ lp["wk"] + lp["bk"]).reshape(B, T, H, hd)
        v = (x @ lp["wv"] + lp["bv"]).reshape(B, T, H, hd)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale + bias
        p = torch.softmax(s, dim=-1)
        a = torch.einsum("bhqk,bkhd->bqhd", p, v).reshape(B, T, cfg.dim)
        a = a @ lp["wo"] + lp["bo"]
        x = _ln(x + a, lp["attn_norm_w"], lp["attn_norm_b"], eps)
        f = F.gelu(x @ lp["w_up"] + lp["b_up"], approximate="none")
        f = f @ lp["w_down"] + lp["b_down"]
        x = _ln(x + f, lp["ffn_norm_w"], lp["ffn_norm_b"], eps)
    if cfg.pooling == "cls":
        # bge-family: the [CLS] position's final hidden state
        return x[:, 0, :]
    m = valid.float()[:, :, None]
    return (x * m).sum(dim=1) / torch.clamp(m.sum(dim=1), min=1.0)


def _bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= n in [lo, hi] (clamped)."""
    b = lo
    while b < n and b < hi:
        b *= 2
    return min(b, hi)


def embed_batch(params: Params, cfg: EncoderConfig,
                token_lists: Sequence[Sequence[int]],
                device=None) -> np.ndarray:
    """Pad a list of token-id lists into one [B, T] batch, the batch and
    the length each padded to a power of two (T in [16, max_seq_len]; a
    longer input is cut at T, as the JAX package cuts it), and run one
    forward on ``device`` (default: where the params are). Returns [N, D]
    float32, unnormalized."""
    dev = params["tok_emb"].device if device is None else resolve_device(
        device)
    n = len(token_lists)
    t_max = max((len(t) for t in token_lists), default=1)
    T = _bucket(max(1, t_max), 16, cfg.max_seq_len)
    B = _bucket(max(1, n), 1, 1 << 20)
    toks = np.zeros((B, T), np.int64)
    lens = np.zeros((B,), np.int64)
    for i, ids in enumerate(token_lists):
        ids = list(ids)[:T]
        toks[i, :len(ids)] = ids
        lens[i] = len(ids)
    with torch.inference_mode():
        out = forward(params, cfg, torch.from_numpy(toks).to(dev),
                      torch.from_numpy(lens).to(dev))
        return out[:n].float().cpu().numpy()
