"""Paged-attention decode: the paged-decode kernel's wrapper and its plain
version.

Counterpart of ``paged_decode_attention`` / ``paged_decode_attention_v3``
in ``ollama_operator_tpu/ops/pallas/paged.py``: single-token attention for
each slot against the physical page pool through its block table.

Pool layout of the port (chosen here, written down in PERF.md):

    dense: [L, P, KvH, ps, hd] bf16 (f32 on the CPU)
    int8:  {"q": [L, P, KvH, ps, hd] int8, "s": [L, P, KvH, ps] f32}
    int4:  {"q4": [L, P, KvH, ps//2, hd] uint8, "s": [L, P, KvH, ps] f32}

(int4: byte row j of a page holds positions 2j and 2j + 1 in its low and
high nibbles, ``ops/quant_cache.py``).

with the true head dim (the JAX package pads hd to 128 lanes and the scale
pool's last axis to 128 for the TPU's tiling; the card needs neither, and
hd = 128 models are untouched either way).

:func:`paged_decode_attention` launches ``csrc/paged_decode.cu`` for
tensors on the card and runs :func:`paged_decode_attention_plain` (gather
the attended pages, then the einsum attention) for tensors on the CPU.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_build
from .attention import NEG_INF, attend_hf
from .quant_cache import attend_hf_q, attend_hf_q4, pool_codes


def _gather_pages(pool: torch.Tensor, layer: int, tbl: torch.Tensor
                  ) -> torch.Tensor:
    """Layer ``layer`` pages ``tbl`` [B, NA] → contiguous logical view
    [B, KvH, NA*ps(, hd)]."""
    pages = pool[layer][tbl]                    # [B, NA, KvH, ps(, hd)]
    if pages.dim() == 5:
        B, NA, KvH, ps, hd = pages.shape
        return pages.permute(0, 2, 1, 3, 4).reshape(B, KvH, NA * ps, hd)
    B, NA, KvH, ps = pages.shape
    return pages.permute(0, 2, 1, 3).reshape(B, KvH, NA * ps)


def paged_decode_attention_plain(q, k_pool, v_pool, layer: int, tables,
                                 lengths, scale: float, softcap: float = 0.0,
                                 sliding_window: int = 0, *, nblk: int):
    """Plain version of the paged-decode kernel: gather the first ``nblk``
    blocks of every slot's table and attend with the causal/window mask
    at the slot's position ``lengths[b]`` (keys 0 .. lengths[b])."""
    quant = isinstance(k_pool, dict)
    ps = (k_pool["s"] if quant else k_pool).shape[3]
    tbl = tables[:, :nblk].long()
    k_pos = torch.arange(nblk * ps, device=q.device)[None, None, :]
    q_pos = lengths.long()[:, None, None]
    ok = k_pos <= q_pos
    if sliding_window:
        ok = ok & (k_pos > q_pos - sliding_window)
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    mask = torch.where(ok, zero, NEG_INF)[:, None]      # [B, 1, 1, S]
    if quant:
        kw, vw = ({k: _gather_pages(v, layer, tbl) for k, v in p.items()}
                  for p in (k_pool, v_pool))
        attend = attend_hf_q4 if "q4" in k_pool else attend_hf_q
        return attend(q, kw, vw, mask, scale, softcap)
    kw = _gather_pages(k_pool, layer, tbl)
    vw = _gather_pages(v_pool, layer, tbl)
    return attend_hf(q, kw, vw, mask, scale, softcap)


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


def paged_decode_attention(q, k_pool, v_pool, layer: int, tables, lengths,
                           scale: float, softcap: float = 0.0,
                           sliding_window: int = 0, *, nblk: int):
    """Single-token attention against the paged pool.

    q [B, 1, H, hd]; pools in the layout above; ``layer`` which L slice;
    tables [B, NBLK] int32 physical page per logical block; lengths [B]
    int32, the query's absolute position (its own K/V already written at
    that position); ``nblk`` the attended width in blocks (<= NBLK; the
    kernel walks only each slot's live pages within the table).
    → [B, 1, H, hd] (q.dtype).

    On the card this launches ``csrc/paged_decode.cu`` (bf16 q; int8,
    int4 or bf16 pools; H / KvH <= 8, ps <= 128 and even for int4,
    hd % 4 == 0, hd <= 256) and raises on anything it does not take; on
    the CPU it runs :func:`paged_decode_attention_plain`."""
    quant = isinstance(k_pool, dict)
    pools = ((pool_codes(k_pool), k_pool["s"], pool_codes(v_pool),
              v_pool["s"]) if quant else (k_pool, v_pool))
    if not cuda_build.on_card(q, tables, lengths, *pools):
        return paged_decode_attention_plain(
            q, k_pool, v_pool, layer, tables, lengths, scale, softcap,
            sliding_window, nblk=nblk)
    quant4 = quant and "q4" in k_pool
    k_arr, v_arr = pools[0], pools[2 if quant else 1]
    B, T, H, hd = q.shape
    L, P, KvH, rows, hd_pool = k_arr.shape
    ps = 2 * rows if quant4 else rows
    NBLK = tables.shape[1]
    if T != 1 or q.dtype != torch.bfloat16:
        raise ValueError(f"paged_decode kernel takes bf16 q [B, 1, H, hd]; "
                         f"got {tuple(q.shape)} {q.dtype}")
    if (hd_pool != hd or H % KvH or H // KvH > 8 or ps > 128 or hd % 4
            or hd > 256 or nblk > NBLK or not 0 <= layer < L):
        raise ValueError(f"paged_decode kernel: H={H} KvH={KvH} ps={ps} "
                         f"hd={hd} pool hd={hd_pool} nblk={nblk}/{NBLK} "
                         f"layer={layer}/{L} unsupported")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    for t in pools + (tables, lengths):
        if not t.is_contiguous():
            raise ValueError("paged_decode kernel needs contiguous pools, "
                             "tables and lengths")
    if quant:
        code_dtype = torch.uint8 if quant4 else torch.int8
        if (k_arr.dtype != code_dtype or v_arr.dtype != code_dtype
                or v_arr.shape != k_arr.shape
                or any(p["s"].dtype != torch.float32
                       or p["s"].shape != (L, P, KvH, ps)
                       for p in (k_pool, v_pool))):
            raise TypeError(f"{'int4' if quant4 else 'int8'} pool needs "
                            f"{code_dtype} codes [L, P, KvH, "
                            f"{'ps/2' if quant4 else 'ps'}, hd] and f32 "
                            f"[L, P, KvH, ps] scales")
    elif k_arr.dtype != torch.bfloat16:
        raise TypeError(f"paged_decode kernel takes int8, int4 or bf16 "
                        f"pools, got {k_arr.dtype}")
    q = q.contiguous()
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream
    tail = [B, H, KvH, hd, P, ps, NBLK, int(layer), float(scale),
            float(softcap or 0.0), int(sliding_window), stream]
    tail_types = [_INT] * 8 + [_FLT, _FLT, _INT, _PTR]
    if quant:
        symbol = "paged_decode_int4" if quant4 else "paged_decode_int8"
        fn = cuda_build.function("paged_decode", symbol,
                                 [_PTR] * 8 + tail_types)
        rc = fn(q.data_ptr(), k_arr.data_ptr(), k_pool["s"].data_ptr(),
                v_arr.data_ptr(), v_pool["s"].data_ptr(), tables.data_ptr(),
                lengths.data_ptr(), out.data_ptr(), *tail)
    else:
        fn = cuda_build.function("paged_decode", "paged_decode_bf16",
                                 [_PTR] * 6 + tail_types)
        rc = fn(q.data_ptr(), k_arr.data_ptr(), v_arr.data_ptr(),
                tables.data_ptr(), lengths.data_ptr(), out.data_ptr(), *tail)
    cuda_build.check(rc, "paged_decode")
    counter = "paged_decode_int4" if quant4 else "paged_decode"
    cuda_build.launches[counter] += 1
    return out
