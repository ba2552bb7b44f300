"""int8 KV cache: quantized storage and attention over it.

Counterpart of ``ollama_operator_tpu/ops/quant_cache.py`` (int8 part; the
nibble-packed int4 pool waits for a later slice). Layout mirrors the dense
cache plus a scale array one axis short:

    q [.., KvH, S, hd] int8      s [.., KvH, S] f32

Scores pick up the key scale after the q·k dot (it is per key position, so
it factors out) and the value scale folds into the probabilities before
the p·v dot, so dequantized K/V tensors never exist:

    scores[.., t, j] = (q_t · kq_j) * ks_j
    out[.., t]       = Σ_j (p_tj * vs_j) · vq_j
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from .attention import softcap_scores


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] float → (int8 [..., hd], f32 scale [...]): symmetric,
    one scale per vector (amax / 127)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 127.0
    q = torch.round(xf / torch.clamp(s[..., None], min=1e-30))
    return q.clamp(-127, 127).to(torch.int8), s


def attend_hf_q(q, kc: Dict, vc: Dict, mask, scale: float,
                softcap: float = 0.0):
    """Grouped-query attention against the quantized head-first cache.

    q [B, T, H, hd]; kc/vc {"q" [B, KvH, S, hd] int8, "s" [B, KvH, S]};
    mask [B, 1, T, S] additive → [B, T, H, hd] (q.dtype). f32 math."""
    B, T, H, hd = q.shape
    kq, ks = kc["q"], kc["s"]
    vq, vs = vc["q"], vc["s"]
    KvH = kq.shape[1]
    G = H // KvH
    qg = q.reshape(B, T, KvH, G, hd).float()
    scores = torch.einsum("btkgh,bksh->bkgts", qg, kq.float())
    scores = scores * ks[:, :, None, None, :]
    scores = softcap_scores(scores * scale, softcap)
    scores = scores + mask[:, :, None, :, :]
    probs = torch.softmax(scores, dim=-1)
    pv = probs * vs[:, :, None, None, :]
    out = torch.einsum("bkgts,bksh->btkgh", pv, vq.float())
    return out.reshape(B, T, H, hd).to(q.dtype)
