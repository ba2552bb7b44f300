"""Paged-attention decode: the three paged-decode kernels' wrappers, their
route, and their plain version.

Counterpart of ``paged_decode_attention`` (the dispatcher and the v2 grid
kernel), ``paged_decode_attention_v3`` and ``paged_decode_attention_v4``
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

:func:`paged_decode_attention` routes as the JAX dispatcher does, reading
its two knobs at the call (:func:`paged_route`): ``TPU_PAGED_V4=1`` to
:func:`paged_decode_attention_v4` (``csrc/paged_decode_v4.cu``), else
``TPU_PAGED_V3`` other than ``"1"`` to :func:`paged_decode_attention_v2`
(``csrc/paged_decode_v2.cu``), else :func:`paged_decode_attention_v3`
(``csrc/paged_decode.cu``). The three kernels take the same shapes, so the
knobs alone decide the route. Each wrapper launches its kernel for tensors
on the card and runs :func:`paged_decode_attention_plain` for tensors on
the CPU. On the card all three run 32-position tiles on the tensor cores
(``csrc/paged_tiles.cuh``): v3 and v2 split each slot's table in chunks
of :func:`paged_chunk_pages` pages, one CTA a chunk (v2 over the first
``nblk`` blocks only); v4 spreads a fixed number of CTAs a kv head over a
flat list of every slot's live chunks built on the card
(:func:`paged_v4_plan`). A slot's bits depend on its own length only, and
v2 and v4 give v3's bits when ``nblk`` covers every live page.

The routes differ in one thing, which keys ``nblk`` lets through: v2 and
v4 attend the first ``nblk`` blocks of a slot's table and ignore keys at
or past ``nblk * ps``; v3 walks every live page of the table whatever
``nblk`` is. The engine passes an ``nblk`` that covers every active slot,
so serving never sees the difference.
"""

from __future__ import annotations

import ctypes
import itertools
import os

import torch

from . import cuda_build
from .attention import NEG_INF, softcap_scores
from .quant_cache import pool_codes, unpack_kv4

ROUTES = ("v2", "v3", "v4")


def paged_route() -> str:
    """The paged-decode kernel the knobs pick now: "v4" when
    ``TPU_PAGED_V4`` is "1", else "v3" when ``TPU_PAGED_V3`` is "1" (its
    default), else "v2" (the JAX dispatcher's order)."""
    if os.environ.get("TPU_PAGED_V4", "0") == "1":
        return "v4"
    if os.environ.get("TPU_PAGED_V3", "1") == "1":
        return "v3"
    return "v2"


def paged_shape_error(H: int, KvH: int, hd: int, ps: int, quant4: bool):
    """Why the paged-decode kernels cannot take these heads and pages, or
    None. The three kernels share their limits: H a multiple of KvH with
    H / KvH <= 8, hd % 4 == 0 and hd <= 256, ps <= 128, and ps even for an
    int4 pool."""
    if KvH <= 0 or H % KvH or H // KvH > 8:
        return f"H={H} KvH={KvH}: the group H / KvH must be at most 8"
    if hd % 4 or hd > 256:
        return f"hd={hd}: must be a multiple of 4, at most 256"
    if ps > 128 or (quant4 and ps % 2):
        return f"page size {ps}: must be at most 128 (and even for int4)"
    return None


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
                                 sliding_window: int = 0, *, nblk: int,
                                 route: str = None):
    """Plain version of the paged-decode kernel of ``route`` (default: the
    knobs' :func:`paged_route`). It attends keys 0 .. lengths[b] of each
    slot (only those inside ``sliding_window``) in the first ``nblk``
    blocks of its table for "v2" and "v4", in every block of the table for
    "v3", and computes what the TPU kernels compute: page by page in block
    order, an f32 online softmax from the running max (scores scaled, then
    the key scale, then the softcap), the probabilities times the value
    scale rounded to q's dtype before the p . v product, the sum l over
    the unrounded probabilities, out = acc / max(l, 1e-30) (0 for a slot
    with no key in range)."""
    route = route or paged_route()
    if route not in ROUTES:
        raise ValueError(f"paged route {route!r}; expected one of {ROUTES}")
    quant = isinstance(k_pool, dict)
    ps = (k_pool["s"] if quant else k_pool).shape[3]
    W = tables.shape[1] if route == "v3" else nblk
    tbl = tables[:, :W].long()
    B, _, H, hd = q.shape
    if quant:
        kc, vc = (_gather_pages(pool_codes(p), layer, tbl)
                  for p in (k_pool, v_pool))
        if "q4" in k_pool:
            kc, vc = unpack_kv4(kc), unpack_kv4(vc)
        ks, vs = (_gather_pages(p["s"], layer, tbl) for p in (k_pool, v_pool))
    else:
        kc = _gather_pages(k_pool, layer, tbl)
        vc = _gather_pages(v_pool, layer, tbl)
    KvH = kc.shape[1]
    G = H // KvH
    qg = q.reshape(B, KvH, G, hd).float()
    s = torch.einsum("bkgh,bksh->bkgs", qg, kc.float()) * scale
    if quant:
        s = s * ks[:, :, None, :]
    s = softcap_scores(s, softcap)
    k_pos = torch.arange(W * ps, device=q.device)[None, :]
    q_pos = lengths.long()[:, None]
    ok = k_pos <= q_pos
    if sliding_window:
        ok = ok & (k_pos > q_pos - sliding_window)
    s = torch.where(ok[:, None, None, :], s, NEG_INF)
    s = s.reshape(B, KvH, G, W, ps)
    # the running max after each page, and each page's share of the final
    # (acc, l): the online update's chain of rescalings, as one factor
    m_run = s.amax(dim=-1).cummax(dim=-1).values          # [B, KvH, G, W]
    zero = torch.zeros((), dtype=torch.float32, device=q.device)
    p = torch.where(m_run[..., None] > NEG_INF / 2,
                    torch.exp(s - m_run[..., None]), zero)
    l_page = p.sum(dim=-1)
    if quant:
        p = p * vs.reshape(B, KvH, 1, W, ps)
    p = p.to(q.dtype).float()
    acc_page = torch.einsum("bkgwp,bkwph->bkgwh", p,
                            vc.float().reshape(B, KvH, W, ps, hd))
    w = torch.exp(m_run - m_run[..., -1:])
    acc = (acc_page * w[..., None]).sum(dim=3)
    l = (l_page * w).sum(dim=-1, keepdim=True)
    out = acc / torch.clamp(l, min=1e-30)
    return out.reshape(B, 1, H, hd).to(q.dtype)


# Positions a CTA of the v3 kernel takes: it splits each slot's table in
# chunks of the whole pages within this many positions (at least one page),
# folds a chunk's live rows into a partial softmax state and merges the
# chunks in a second launch. A positive multiple of the kernel's
# 32-position tile. 512 measured fastest on the H100 at the engine's
# decode step (every slot of the table) and at the 64-slot main shape
# (PERF.md section 6, hack/paged_v3_variants.py).
PAGED_CHUNK = 512


def paged_chunk_pages(ps: int, chunk: int = None) -> int:
    """Table blocks a chunk of the v3 kernel holds at page size ``ps``: the
    whole pages within ``chunk`` positions (default :data:`PAGED_CHUNK`),
    at least one. Raises unless the chunk is a positive multiple of the
    kernel's 32-position tile."""
    chunk = PAGED_CHUNK if chunk is None else chunk
    if chunk <= 0 or chunk % 32:
        raise ValueError(f"paged_decode kernel splits a slot's pages in "
                         f"chunks of a positive multiple of 32 positions; "
                         f"the chunk is {chunk}")
    return max(1, chunk // ps)


def paged_chunk_blocks(length: int, width: int, ps: int, window: int,
                       chunk_pages: int):
    """The table blocks each CTA of the split kernels walks for a slot
    whose query sits at ``length``: one ``range`` per chunk z of
    ``ceil(width / chunk_pages)``, the live blocks (from the window's first
    block to the block of ``length``, within the attended ``width``: the
    table's NBLK for v3, whatever ``nblk`` is, and ``nblk`` for v2) inside
    [z * chunk_pages, (z + 1) * chunk_pages), empty for a chunk past
    ``length`` or before the window (as ``csrc/paged_tiles.cuh``
    ``chunk_rows`` computes them, in rows). The chunk count depends on the
    width and the chunk only."""
    last = min(length // ps + 1, width)
    first = max(0, (length - window + 1) // ps) if window > 0 else 0
    return [range(max(first, z * chunk_pages),
                  min(last, (z + 1) * chunk_pages))
            for z in range(-(-width // chunk_pages))]


# CTAs a call of the v4 kernel spreads over each kv head's flat list of
# live units (each slot's live chunks of :func:`paged_chunk_pages` blocks):
# PAGED_V4_CTAS // KvH of them a kv head, at least one and at most the
# units there can be, each taking an equal share of the list. Fixed by the
# shapes, never by the lengths, so the call needs no host sync.
PAGED_V4_CTAS = 4096


def paged_v4_chunks(B: int, KvH: int, nunit: int) -> int:
    """CTAs per kv head of a v4 kernel call over ``B`` slots of at most
    ``nunit`` units each: ``PAGED_V4_CTAS // KvH``, at least 1 and at most
    ``B * nunit``."""
    return max(1, min(PAGED_V4_CTAS // KvH, B * nunit))


def paged_v4_plan(lengths, nblk: int, ps: int, window: int, chunk_pages: int,
                  chunks: int):
    """The v4 kernel's flat list and its CTAs' shares, as
    ``csrc/paged_decode_v4.cu`` builds them on the device for one kv head.

    Slot b's units are its live chunks of ``chunk_pages`` blocks within the
    first ``nblk`` (:func:`paged_chunk_blocks` with width ``nblk``), slot by
    slot in chunk order; unit n's partial is run n. CTA c folds units
    [c * share, (c + 1) * share), share = ceil(total / chunks), each whole.
    Returns (units, share, runs): units[n] = (b, the unit's blocks as a
    ``range``); runs[b] = (the slot's first run, its run count), which the
    merge walks in order."""
    units = [(b, r) for b, length in enumerate(int(x) for x in lengths)
             for r in paged_chunk_blocks(length, nblk, ps, window,
                                         chunk_pages) if len(r)]
    counts = [sum(1 for u in units if u[0] == b) for b in range(len(lengths))]
    runs = [(start - n, n) for start, n in
            zip(itertools.accumulate(counts), counts)]
    return units, -(-len(units) // chunks), runs


_PTR = ctypes.c_void_p
_INT = ctypes.c_int
_FLT = ctypes.c_float


def _pool_tensors(k_pool, v_pool):
    if isinstance(k_pool, dict):
        return (pool_codes(k_pool), k_pool["s"], pool_codes(v_pool),
                v_pool["s"])
    return (k_pool, v_pool)


def _launch(route: str, q, k_pool, v_pool, layer: int, tables, lengths,
            scale: float, softcap: float, sliding_window: int, nblk: int):
    """Check the inputs and launch the CUDA kernel of ``route``; raises on
    anything the kernel does not take. Returns [B, 1, H, hd] bf16."""
    quant = isinstance(k_pool, dict)
    quant4 = quant and "q4" in k_pool
    k_arr = pool_codes(k_pool) if quant else k_pool
    v_arr = pool_codes(v_pool) if quant else v_pool
    scales = (k_pool["s"], v_pool["s"]) if quant else ()
    B, T, H, hd = q.shape
    L, P, KvH, rows, hd_pool = k_arr.shape
    ps = 2 * rows if quant4 else rows
    NBLK = tables.shape[1]
    if T != 1 or q.dtype != torch.bfloat16:
        raise ValueError(f"paged_decode kernel takes bf16 q [B, 1, H, hd]; "
                         f"got {tuple(q.shape)} {q.dtype}")
    why = paged_shape_error(H, KvH, hd, ps, quant4)
    if why or hd_pool != hd or not 0 < nblk <= NBLK or not 0 <= layer < L:
        raise ValueError(f"paged_decode kernel: {why or ''} pool hd="
                         f"{hd_pool} nblk={nblk}/{NBLK} layer={layer}/{L}")
    if route == "v4" and B > 1024:
        raise ValueError(f"paged_decode_v4 kernel takes at most 1024 "
                         f"slots, got {B}")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("tables and lengths must be int32")
    for t in (k_arr, v_arr, *scales, tables, lengths):
        if not t.is_contiguous():
            raise ValueError("paged_decode kernel needs contiguous pools, "
                             "tables and lengths")
    # the chunk of the split (v3 over the whole table, v2 over its first
    # nblk blocks) and of v4's units
    chunk_pages = paged_chunk_pages(ps)
    nunit = -(-(NBLK if route == "v3" else nblk) // chunk_pages)
    if k_arr.data_ptr() % 16 or v_arr.data_ptr() % 16:
        raise ValueError("paged_decode kernel copies pool rows in "
                         "16-byte pieces: the pools must be 16-byte "
                         "aligned")
    if quant:
        code_dtype = torch.uint8 if quant4 else torch.int8
        if (k_arr.dtype != code_dtype or v_arr.dtype != code_dtype
                or v_arr.shape != k_arr.shape
                or any(s.dtype != torch.float32
                       or s.shape != (L, P, KvH, ps) for s in scales)):
            raise TypeError(f"{'int4' if quant4 else 'int8'} pool needs "
                            f"{code_dtype} codes [L, P, KvH, "
                            f"{'ps/2' if quant4 else 'ps'}, hd] and f32 "
                            f"[L, P, KvH, ps] scales")
    elif k_arr.dtype != torch.bfloat16 or v_arr.dtype != torch.bfloat16:
        raise TypeError(f"paged_decode kernel takes int8, int4 or bf16 "
                        f"pools, got {k_arr.dtype}")
    q = q.contiguous()
    out = torch.empty_like(q)
    ks, vs = (s.data_ptr() for s in scales) if quant else (None, None)
    args = [q.data_ptr(), k_arr.data_ptr(), ks, v_arr.data_ptr(), vs,
            tables.data_ptr(), lengths.data_ptr(), out.data_ptr()]
    types = [_PTR] * 8
    # per (run, kv head, group row): the partial softmax state, merged by
    # the kernel's second launch; acc [runs, KvH, G, hd] then (m, l)
    # [runs, KvH, G, 2] in one allocation, a run per (slot, chunk) (v4:
    # at most that many, one a live unit, then each slot's first run and
    # run count as int32)
    runs = B * nunit
    part = torch.empty(runs * H * (hd + 2) + (2 * B if route == "v4" else 0),
                       dtype=torch.float32, device=q.device)
    args += [part.data_ptr(), part.data_ptr() + 4 * runs * H * hd,
             B, H, KvH, hd, P, ps, NBLK, nblk, int(layer), float(scale),
             float(softcap or 0.0), int(sliding_window), chunk_pages]
    types += [_PTR] * 2 + [_INT] * 9 + [_FLT, _FLT, _INT, _INT]
    if route == "v4":
        args.append(paged_v4_chunks(B, KvH, nunit))
        types.append(_INT)
    lib = {"v2": "paged_decode_v2", "v3": "paged_decode",
           "v4": "paged_decode_v4"}[route]
    pool = "int4" if quant4 else "int8" if quant else "bf16"
    fn = cuda_build.function(lib, f"{lib}_{pool}", types + [_PTR])
    rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, lib)
    return out


def _paged(route: str, q, k_pool, v_pool, layer: int, tables, lengths,
           scale: float, softcap: float, sliding_window: int, nblk: int):
    """The kernel of ``route`` for tensors on the card (counting its
    launch), its plain version for tensors on the CPU."""
    if not cuda_build.on_card(q, tables, lengths,
                              *_pool_tensors(k_pool, v_pool)):
        return paged_decode_attention_plain(
            q, k_pool, v_pool, layer, tables, lengths, scale, softcap,
            sliding_window, nblk=nblk, route=route)
    out = _launch(route, q, k_pool, v_pool, layer, tables, lengths, scale,
                  softcap, sliding_window, nblk)
    if route != "v3":
        counter = f"paged_decode_{route}"
    elif isinstance(k_pool, dict) and "q4" in k_pool:
        counter = "paged_decode_int4"
    else:
        counter = "paged_decode"
    cuda_build.launches[counter] += 1
    return out


def paged_decode_attention_v3(q, k_pool, v_pool, layer: int, tables,
                              lengths, scale: float, softcap: float = 0.0,
                              sliding_window: int = 0, *, nblk: int):
    """Single-token attention against the paged pool (the TPU's v3).

    q [B, 1, H, hd]; pools in the layout above; ``layer`` which L slice;
    tables [B, NBLK] int32 physical page per logical block; lengths [B]
    int32, the query's absolute position (its own K/V already written at
    that position); ``nblk`` the attended width in blocks (<= NBLK; this
    kernel walks each slot's live pages within the whole table).
    → [B, 1, H, hd] (q.dtype).

    On the card this launches ``csrc/paged_decode.cu`` (bf16 q; int8,
    int4 or bf16 pools; the limits of :func:`paged_shape_error`), which
    splits each slot's table in chunks of :func:`paged_chunk_pages` pages
    (:func:`paged_chunk_blocks`), folds each chunk's live rows on its own
    CTA (on tensor cores when hd % 16 == 0) and merges the chunks in a
    second launch, and raises on anything it does not take; on the CPU it
    runs :func:`paged_decode_attention_plain` with v3's contract."""
    return _paged("v3", q, k_pool, v_pool, layer, tables, lengths, scale,
                  softcap, sliding_window, nblk)


def paged_decode_attention_v2(q, k_pool, v_pool, layer: int, tables,
                              lengths, scale: float, softcap: float = 0.0,
                              sliding_window: int = 0, *, nblk: int):
    """:func:`paged_decode_attention_v3`'s arguments, with the TPU v2 grid
    kernel's contract (keys in the first ``nblk`` blocks only): on the
    card ``csrc/paged_decode_v2.cu`` (the v3 kernel's split over the first
    ``nblk`` blocks: chunks of :func:`paged_chunk_pages` pages, each on its
    own CTA, merged in a second launch), on the CPU the plain version with
    route "v2"."""
    return _paged("v2", q, k_pool, v_pool, layer, tables, lengths, scale,
                  softcap, sliding_window, nblk)


def paged_decode_attention_v4(q, k_pool, v_pool, layer: int, tables,
                              lengths, scale: float, softcap: float = 0.0,
                              sliding_window: int = 0, *, nblk: int):
    """:func:`paged_decode_attention_v3`'s arguments, with the TPU v4 flat
    grid kernel's contract (keys in the first ``nblk`` blocks only): on
    the card ``csrc/paged_decode_v4.cu`` (:func:`paged_v4_chunks` CTAs a
    kv head folding equal shares of the flat list of every slot's live
    chunks, :func:`paged_v4_plan`, then a merge in list order; at most 1024
    slots), on the CPU the plain version with route "v4"."""
    return _paged("v4", q, k_pool, v_pool, layer, tables, lengths, scale,
                  softcap, sliding_window, nblk)


_ROUTED = {"v2": paged_decode_attention_v2, "v3": paged_decode_attention_v3,
           "v4": paged_decode_attention_v4}


def paged_decode_attention(q, k_pool, v_pool, layer: int, tables, lengths,
                           scale: float, softcap: float = 0.0,
                           sliding_window: int = 0, *, nblk: int):
    """Single-token attention against the paged pool through the kernel
    that :func:`paged_route` picks at this call (the JAX dispatcher's
    knobs; arguments as :func:`paged_decode_attention_v3`)."""
    return _ROUTED[paged_route()](q, k_pool, v_pool, layer, tables, lengths,
                                  scale, softcap, sliding_window, nblk=nblk)
