"""int8/int4 KV cache: quantized storage and attention over it.

Counterpart of ``ollama_operator_tpu/ops/quant_cache.py``. Layout mirrors
the dense cache plus a scale array one axis short:

    q [.., KvH, S, hd] int8      s [.., KvH, S] f32

int4 (paged pools only) keeps the same per-(position, head) scales, with
codes in [-7, 7] (scale = amax / 7) stored two positions a byte along the
position axis: position 2j in the low nibble, 2j + 1 in the high nibble,
both biased by +8 (``uint8`` here; the JAX package stores the same bytes
as int8):

    q4 [.., KvH, S//2, hd] uint8      s [.., KvH, S] f32

An empty pool reads as 0.0: its bytes decode to -8 but its scales are 0.

Scores pick up the key scale after the q·k dot (it is per key position, so
it factors out) and the value scale folds into the probabilities before
the p·v dot, so dequantized K/V tensors never exist:

    scores[.., t, j] = (q_t · kq_j) * ks_j
    out[.., t]       = Σ_j (p_tj * vs_j) · vq_j
"""

from __future__ import annotations

from typing import Dict, Tuple, Union

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
    mask [B, 1, T, S] additive → [B, T, H, hd] (q.dtype). The JAX
    package's rounding: codes meet q in its dtype with f32 products (exact
    for bf16, so f32 math here), the key scale goes onto the f32 scores,
    and the value scale goes into the probabilities before they are
    rounded to q's dtype for the p . v product."""
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
    pv = (probs * vs[:, :, None, None, :]).to(q.dtype).float()
    out = torch.einsum("bkgts,bksh->btkgh", pv, vq.float())
    return out.reshape(B, T, H, hd).to(q.dtype)


# --------------------------------------------------------------------------
# int4 pool codecs
# --------------------------------------------------------------------------

INT4_BIAS = 8   # stored nibble = code + 8, codes in [-7, 7]


def pool_codes(pool: Dict) -> torch.Tensor:
    """The code array of a quantized pool dict ({"q"} int8 or {"q4"}
    nibble-packed)."""
    return pool["q4"] if "q4" in pool else pool["q"]


def pool_bits(pool: Union[Dict, torch.Tensor]) -> int:
    """Code width of a pool: 4 for nibble-packed dicts, 8 for int8 dicts,
    the storage width for plain (unquantized) tensors."""
    if isinstance(pool, dict):
        return 4 if "q4" in pool else 8
    return pool.element_size() * 8


def quantize_kv4(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., hd] float → (int4 codes in [-7, 7] as int8 [..., hd], f32
    scale [...]): symmetric, one scale per vector (amax / 7). Packing is a
    separate step (:func:`pack_kv4`, or the decoder's nibble scatter)."""
    xf = x.float()
    s = xf.abs().amax(dim=-1) / 7.0
    q = torch.round(xf / torch.clamp(s[..., None], min=1e-30))
    return q.clamp(-7, 7).to(torch.int8), s


def pack_kv4(codes: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Pack int4 codes pairwise along ``axis`` (the position axis, even
    size): position 2j → low nibble, 2j + 1 → high nibble, +8 bias.
    Returns uint8 with ``axis`` halved."""
    c = codes.movedim(axis, -1)
    assert c.shape[-1] % 2 == 0, f"pack_kv4: axis size {c.shape[-1]} odd"
    b = (c.to(torch.int16) + INT4_BIAS).to(torch.uint8)
    packed = b[..., 0::2] | (b[..., 1::2] << 4)
    return packed.movedim(-1, axis)


def unpack_kv4(packed: torch.Tensor, axis: int = -2) -> torch.Tensor:
    """Inverse of :func:`pack_kv4`: nibble pairs → int4 codes [-7, 7]
    (int8), ``axis`` doubled."""
    b = packed.movedim(axis, -1).to(torch.uint8)
    lo = (b & 0xF).to(torch.int8) - INT4_BIAS
    hi = (b >> 4).to(torch.int8) - INT4_BIAS
    out = torch.stack([lo, hi], dim=-1).flatten(-2)
    return out.movedim(-1, axis)


def attend_hf_q4(q, kc: Dict, vc: Dict, mask, scale: float,
                 softcap: float = 0.0):
    """:func:`attend_hf_q` over an int4 pool view: the nibble codes are
    unpacked back to per-position int8 codes, then the same scaled-dot
    path runs. kc/vc {"q4" [B, KvH, S//2, hd] uint8, "s" [B, KvH, S]}; q
    [B, T, H, hd]; mask [B, 1, T, S] additive."""
    kc8 = {"q": unpack_kv4(kc["q4"]), "s": kc["s"]}
    vc8 = {"q": unpack_kv4(vc["q4"]), "s": vc["s"]}
    return attend_hf_q(q, kc8, vc8, mask, scale, softcap)
