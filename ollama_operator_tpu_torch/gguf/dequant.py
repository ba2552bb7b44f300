"""Dequantisation of ggml block formats → float32 (vectorised numpy).

A copy of ``ollama_operator_tpu/gguf/dequant.py``, bit for bit the same
math: ggml's dequantize_row_* functions expressed as whole-tensor numpy
array ops. BF16 decodes by shifting its 16 bits into a float32's high half,
so no bfloat16 numpy type is needed. The JAX package's native C++ path
(native/dequant.cpp) gives these same bits on finite values; the port runs
the numpy path only.

Layouts (per block; QK = 32 for legacy formats, 256 for k-quants):
  Q4_0: f16 d | 16B nibbles                    x = (q - 8) d
  Q4_1: f16 d, m | 16B nibbles                 x = q d + m
  Q5_0: f16 d | 4B high-bits | 16B nibbles     x = (q - 16) d
  Q5_1: f16 d, m | 4B | 16B                    x = q d + m
  Q8_0: f16 d | 32×i8                          x = q d
  Q2_K: 16B scales | 64B 2-bit | f16 d, dmin   x = d sc q - dmin m
  Q3_K: 32B hmask | 64B 2-bit | 12B scales | f16 d
  Q4_K: f16 d, dmin | 12B scales | 128B nibbles
  Q5_K: f16 d, dmin | 12B scales | 32B qh | 128B nibbles
  Q6_K: 128B ql | 64B qh | 16×i8 scales | f16 d
Nibble order (legacy): low nibbles of the 16 bytes are elements 0..15, high
nibbles are elements 16..31.
"""

from __future__ import annotations

import numpy as np

from . import reader as R


def _f16(b: np.ndarray) -> np.ndarray:
    """bytes [..., 2] → float32"""
    return b.view(np.float16).astype(np.float32)


# ---------------------------------------------------------------------------
# legacy 32-element blocks
# ---------------------------------------------------------------------------

def dq_q4_0(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 18)
    d = _f16(b[:, :2])                       # [N,1]
    qs = b[:, 2:]
    lo = (qs & 0x0F).astype(np.int8) - 8
    hi = (qs >> 4).astype(np.int8) - 8
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d).reshape(-1)


def dq_q4_1(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 20)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    qs = b[:, 4:]
    q = np.concatenate([qs & 0x0F, qs >> 4], axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)


def _q5_bits(qh_bytes: np.ndarray) -> np.ndarray:
    """4 bytes per block → [N, 32] high bits."""
    qh = qh_bytes.view(np.uint32).reshape(-1, 1)
    return ((qh >> np.arange(32, dtype=np.uint32)) & 1).astype(np.uint8)


def dq_q5_0(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 22)
    d = _f16(b[:, 0:2])
    hb = _q5_bits(np.ascontiguousarray(b[:, 2:6]))
    qs = b[:, 6:]
    lo = (qs & 0x0F) | (hb[:, :16] << 4)
    hi = (qs >> 4) | (hb[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.int16) - 16
    return (q.astype(np.float32) * d).reshape(-1)


def dq_q5_1(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 24)
    d = _f16(b[:, 0:2])
    m = _f16(b[:, 2:4])
    hb = _q5_bits(np.ascontiguousarray(b[:, 4:8]))
    qs = b[:, 8:]
    lo = (qs & 0x0F) | (hb[:, :16] << 4)
    hi = (qs >> 4) | (hb[:, 16:] << 4)
    q = np.concatenate([lo, hi], axis=1).astype(np.float32)
    return (q * d + m).reshape(-1)


def dq_q8_0(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 34)
    d = _f16(b[:, 0:2])
    q = b[:, 2:].view(np.int8).astype(np.float32)
    return (q * d).reshape(-1)


# ---------------------------------------------------------------------------
# k-quants (256-element super-blocks)
# ---------------------------------------------------------------------------

def _expand_2bit(qs: np.ndarray) -> np.ndarray:
    """[N, 64] bytes → [N, 2, 4, 32] values: halves × shifts × lanes, which
    flattens to the ggml element order (half, shift, lane)."""
    N = qs.shape[0]
    q = qs.reshape(N, 2, 32)                      # two 32-byte halves
    shifts = np.array([0, 2, 4, 6], np.uint8).reshape(1, 1, 4, 1)
    return (q[:, :, None, :] >> shifts) & 3       # [N, 2, 4, 32]


def dq_q2_k(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 84)
    N = b.shape[0]
    scales = b[:, :16]                            # 16 sub-block scale bytes
    qs = b[:, 16:80]
    d = _f16(b[:, 80:82])                         # [N,1]
    dmin = _f16(b[:, 82:84])
    q = _expand_2bit(qs).astype(np.float32)       # [N,2,4,32]
    sc = (scales & 0xF).astype(np.float32).reshape(N, 2, 4, 2, 1)
    mn = (scales >> 4).astype(np.float32).reshape(N, 2, 4, 2, 1)
    qv = q.reshape(N, 2, 4, 2, 16)
    y = d.reshape(N, 1, 1, 1, 1) * sc * qv - dmin.reshape(N, 1, 1, 1, 1) * mn
    return y.reshape(-1)


def _q3k_scales(sb: np.ndarray) -> np.ndarray:
    """12 scale bytes → 16 signed 6-bit scales (ggml aux/kmask unpack)."""
    N = sb.shape[0]
    a = sb[:, :4]
    bb = sb[:, 4:8]
    c = sb[:, 8:12]
    lo = np.concatenate([a & 0xF, bb & 0xF, a >> 4, bb >> 4], axis=1)
    hi_shift = np.repeat(np.arange(4, dtype=np.uint8) * 2, 4).reshape(1, 16)
    hi = (c[:, [0, 1, 2, 3] * 4] >> hi_shift) & 3
    return (lo | (hi << 4)).astype(np.int16) - 32  # [N,16]


def dq_q3_k(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 110)
    N = b.shape[0]
    hmask = b[:, :32]
    qs = b[:, 32:96]
    scales = _q3k_scales(b[:, 96:108]).astype(np.float32)  # [N,16]
    d = _f16(b[:, 108:110])
    q = _expand_2bit(qs).astype(np.int16)         # [N,2,4,32]
    bit = np.arange(8, dtype=np.uint8).reshape(1, 2, 4, 1)
    h = (hmask[:, None, None, :] >> bit) & 1      # [N,2,4,32]
    q = q - (1 - h.astype(np.int16)) * 4
    sc = scales.reshape(N, 2, 4, 2, 1)
    y = d.reshape(N, 1, 1, 1, 1) * sc * q.reshape(N, 2, 4, 2, 16)
    return y.reshape(-1)


def _k4_scale_min(sb: np.ndarray):
    """12 bytes → (scales[N,8], mins[N,8]) 6-bit (get_scale_min_k4)."""
    s = sb.astype(np.uint8)
    sc = np.empty(s.shape[:1] + (8,), np.uint8)
    mn = np.empty_like(sc)
    sc[:, :4] = s[:, 0:4] & 63
    mn[:, :4] = s[:, 4:8] & 63
    sc[:, 4:] = (s[:, 8:12] & 0xF) | ((s[:, 0:4] >> 6) << 4)
    mn[:, 4:] = (s[:, 8:12] >> 4) | ((s[:, 4:8] >> 6) << 4)
    return sc.astype(np.float32), mn.astype(np.float32)


def dq_q4_k(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 144)
    N = b.shape[0]
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k4_scale_min(b[:, 4:16])            # [N,8]
    qs = b[:, 16:].reshape(N, 4, 32)              # 4 chunks of 64 elems
    lo = (qs & 0xF).astype(np.float32)            # [N,4,32] → sub-blocks 0,2,4,6
    hi = (qs >> 4).astype(np.float32)             # sub-blocks 1,3,5,7
    q = np.stack([lo, hi], axis=2)                # [N,4,2,32]
    dd = d.reshape(N, 1, 1, 1) * sc.reshape(N, 4, 2, 1)
    mm = dmin.reshape(N, 1, 1, 1) * mn.reshape(N, 4, 2, 1)
    return (dd * q - mm).reshape(-1)


def dq_q5_k(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 176)
    N = b.shape[0]
    d = _f16(b[:, 0:2])
    dmin = _f16(b[:, 2:4])
    sc, mn = _k4_scale_min(b[:, 4:16])
    qh = b[:, 16:48]                              # [N,32]
    qs = b[:, 48:].reshape(N, 4, 32)
    lo = (qs & 0xF).astype(np.uint8)
    hi = (qs >> 4).astype(np.uint8)
    # chunk j: low-nibble bit = 2j, high-nibble bit = 2j+1 (u1/u2 <<= 2)
    jbits = np.arange(4, dtype=np.uint8).reshape(1, 4, 1)
    hlo = (qh[:, None, :] >> (2 * jbits)) & 1
    hhi = (qh[:, None, :] >> (2 * jbits + 1)) & 1
    q = np.stack([lo + 16 * hlo, hi + 16 * hhi], axis=2).astype(np.float32)
    dd = d.reshape(N, 1, 1, 1) * sc.reshape(N, 4, 2, 1)
    mm = dmin.reshape(N, 1, 1, 1) * mn.reshape(N, 4, 2, 1)
    return (dd * q - mm).reshape(-1)


def dq_q6_k(raw: np.ndarray) -> np.ndarray:
    b = raw.reshape(-1, 210)
    N = b.shape[0]
    ql = b[:, :128].reshape(N, 2, 64)             # two halves of 128 elems
    qh = b[:, 128:192].reshape(N, 2, 32)
    scales = b[:, 192:208].view(np.int8).astype(np.float32).reshape(N, 2, 8)
    d = _f16(b[:, 208:210])
    l_lo, l_hi = ql[:, :, :32], ql[:, :, 32:]
    h = qh                                         # [N,2,32]
    q1 = (l_lo & 0xF) | (((h >> 0) & 3) << 4)
    q2 = (l_hi & 0xF) | (((h >> 2) & 3) << 4)
    q3 = (l_lo >> 4) | (((h >> 4) & 3) << 4)
    q4 = (l_hi >> 4) | (((h >> 6) & 3) << 4)
    q = np.stack([q1, q2, q3, q4], axis=2).astype(np.int16) - 32  # [N,2,4,32]
    # scale idx within a half: row k (of 4) × lane l: is = k*2 + l//16
    sc = scales.reshape(N, 2, 4, 2, 1)
    y = d.reshape(N, 1, 1, 1, 1) * sc * q.reshape(N, 2, 4, 2, 16).astype(
        np.float32)
    return y.reshape(-1)


# ---------------------------------------------------------------------------
# i-quants (non-linear 4-bit: shared LUT; ggml dequantize_row_iq4_nl/_xs)
# ---------------------------------------------------------------------------

# kvalues_iq4nl: the non-linear code→value map both iq4 formats share
_IQ4NL_LUT = np.array([-127, -104, -83, -65, -49, -35, -22, -10,
                       1, 13, 25, 38, 53, 69, 89, 113], np.float32)


def dq_iq4_nl(raw: np.ndarray) -> np.ndarray:
    """32-elem blocks, q4_0 layout (f16 d | 16B nibbles); codes map
    through the non-linear LUT instead of (q - 8)."""
    b = raw.reshape(-1, 18)
    d = _f16(b[:, :2])                       # [N,1]
    qs = b[:, 2:]
    lo = _IQ4NL_LUT[qs & 0x0F]
    hi = _IQ4NL_LUT[qs >> 4]
    q = np.concatenate([lo, hi], axis=1)
    return (q * d).reshape(-1)


def dq_iq4_xs(raw: np.ndarray) -> np.ndarray:
    """256-elem super-blocks: f16 d | u16 scales_h | 4B scales_l |
    128B nibbles. Sub-block ib (of 8×32): 6-bit scale
    ls = scales_l nibble | scales_h 2-bit pair << 4, value
    d·(ls-32)·LUT[q]; within a sub-block low nibbles are elements
    0..15, high 16..31."""
    b = raw.reshape(-1, 136)
    N = b.shape[0]
    d = _f16(b[:, 0:2])                              # [N,1]
    scales_h = np.ascontiguousarray(b[:, 2:4]).view(np.uint16)  # [N,1]
    scales_l = b[:, 4:8]                             # [N,4]
    qs = b[:, 8:].reshape(N, 8, 16)                  # [N, ib, 16]
    ib = np.arange(8)
    ls_l = (scales_l[:, ib // 2] >> (4 * (ib % 2))) & 0xF       # [N,8]
    ls_h = (scales_h >> (2 * ib).astype(np.uint16)) & 3         # [N,8]
    ls = (ls_l | (ls_h << 4)).astype(np.float32) - 32
    dl = (d * ls).reshape(N, 8, 1)                   # [N,8,1]
    lo = _IQ4NL_LUT[qs & 0x0F]                       # [N,8,16]
    hi = _IQ4NL_LUT[qs >> 4]
    y = dl * np.concatenate([lo, hi], axis=2)        # [N,8,32]
    return y.reshape(-1)


# ---------------------------------------------------------------------------
# plain types + dispatch
# ---------------------------------------------------------------------------

def dq_f32(raw: np.ndarray) -> np.ndarray:
    return raw.view(np.float32).copy()


def dq_f16(raw: np.ndarray) -> np.ndarray:
    return raw.view(np.float16).astype(np.float32)


def dq_bf16(raw: np.ndarray) -> np.ndarray:
    u = raw.view(np.uint16).astype(np.uint32) << 16
    return u.view(np.float32)


_DISPATCH = {
    R.GGML_F32: dq_f32, R.GGML_F16: dq_f16, R.GGML_BF16: dq_bf16,
    R.GGML_Q4_0: dq_q4_0, R.GGML_Q4_1: dq_q4_1,
    R.GGML_Q5_0: dq_q5_0, R.GGML_Q5_1: dq_q5_1, R.GGML_Q8_0: dq_q8_0,
    R.GGML_Q2_K: dq_q2_k, R.GGML_Q3_K: dq_q3_k, R.GGML_Q4_K: dq_q4_k,
    R.GGML_Q5_K: dq_q5_k, R.GGML_Q6_K: dq_q6_k,
    R.GGML_IQ4_NL: dq_iq4_nl, R.GGML_IQ4_XS: dq_iq4_xs,
    R.GGML_I8: lambda raw: raw.view(np.int8).astype(np.float32),
    R.GGML_I32: lambda raw: raw.view(np.int32).astype(np.float32),
}


def supported_types():
    return set(_DISPATCH)


# IQ1/IQ2/IQ3 (iq2_xxs/iq2_xs/iq2_s/iq3_xxs/iq3_s/iq1_s/iq1_m) decode
# through large searched codebooks (256–2048-entry sign/magnitude grids
# found by offline optimization in upstream llama.cpp, not derivable from a
# closed-form spec the way the q*_0/K-quant grids and the 16-entry iq4 LUT
# are). Neither package vendors those tables, and approximated codebooks
# would dequantize real registry images to wrong weights, so these types
# fail loudly instead.
_IQ_CODEBOOK_TYPES = {R.GGML_IQ2_XXS, R.GGML_IQ2_XS, R.GGML_IQ3_XXS,
                      R.GGML_IQ1_S, R.GGML_IQ3_S, R.GGML_IQ2_S,
                      R.GGML_IQ1_M}


def dequantize(raw: np.ndarray, ggml_type: int, shape: tuple) -> np.ndarray:
    """raw uint8 buffer → float32 array of ``shape`` (numpy row-major)."""
    if ggml_type not in _DISPATCH:
        name = R.GGML_TYPE_NAMES.get(ggml_type, ggml_type)
        if ggml_type in _IQ_CODEBOOK_TYPES:
            raise NotImplementedError(
                f"ggml type {name}: codebook i-quants need llama.cpp's "
                f"searched grid tables, which are not vendored; re-pull "
                f"the model at q4_0/q8_0/K-quant/iq4 precision")
        raise NotImplementedError(f"ggml type {name} not supported")
    return _DISPATCH[ggml_type](raw).reshape(shape)


def dequantize_tensor(f: "R.GGUFFile", t: "R.GGUFTensor") -> np.ndarray:
    return dequantize(f.raw(t), t.ggml_type, t.shape)
