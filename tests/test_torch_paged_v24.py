"""The launch plans of the v2 (K4) and v4 (K5) paged-decode kernels
(``ollama_operator_tpu_torch/ops/paged.py``, ``csrc/paged_decode_v2.cu``,
``csrc/paged_decode_v4.cu``), held against the JAX v4 kernel's flat list.

The kernels run only on the card (``chip_smoke.py`` holds them against
``paged_decode_attention_plain``); here, on the CPU:

- the JAX v4 list (``ops/pallas/paged.py`` ``paged_decode_attention_v4``:
  ``nlive = min(len // ps + 1, nblk)``, ``ends = cumsum(nlive)``), computed
  with numpy on the same lengths, against the port's plans: v2's chunks of
  the first ``nblk`` blocks (:func:`paged_chunk_blocks`) and v4's flat
  list of every slot's live chunks cut into equal shares
  (:func:`paged_v4_plan`). Each must attend exactly the positions of the
  JAX list that its mask lets through, once each, in list order;
- the wrappers' launch arguments and their one workspace allocation;
- the refusals: more than 1024 slots for v4, a chunk off the 32-position
  tile for either, before anything is allocated.
"""

from __future__ import annotations

import ctypes
import types

import numpy as np
import pytest
import torch

from ollama_operator_tpu_torch.ops import cuda_build
from ollama_operator_tpu_torch.ops import paged as tpaged

torch.set_num_threads(1)


def jax_v4_list(lengths, nblk: int, ps: int):
    """The JAX v4 kernel's flat list, in numpy: (slot, block) of each live
    step, slot by slot (``nlive``/``ends`` of ops/pallas/paged.py)."""
    lengths = np.asarray(lengths, np.int64)
    nlive = np.minimum(lengths // ps + 1, nblk)
    ends = np.cumsum(nlive)
    idx = np.arange(int(ends[-1]))
    slot = np.searchsorted(ends, idx, side="right")
    return list(zip(slot.tolist(), (idx - (ends - nlive)[slot]).tolist()))


def jax_positions(lengths, nblk: int, ps: int, window: int):
    """Per slot, the positions the JAX v4 list attends, in list order:
    each listed page's positions that its mask lets through (p <= length
    and, with a window, p > length - window)."""
    out = [[] for _ in lengths]
    for b, blk in jax_v4_list(lengths, nblk, ps):
        n = int(lengths[b])
        out[b] += [p for p in range(blk * ps, (blk + 1) * ps)
                   if p <= n and (window <= 0 or p > n - window)]
    return out


CASES = [  # (B, ps, nblk, window, chunk positions, CTAs a kv head)
    (32, 64, 64, 2047, 512, 128),  # phi3's path 8: 4096 CTAs, 32 kv heads
    (64, 128, 32, 0, 512, 512),    # llama shapes at 8 kv heads
    (8, 64, 64, 2047, 512, 128),   # the serving step's 8 slots
    (32, 64, 64, 2047, 512, 5),    # few CTAs: shares across many slots
    (7, 16, 5, 24, 32, 3),         # a window inside a unit
    (5, 6, 9, 0, 32, 4),           # pages that do not divide the chunk
    (3, 128, 2, 100, 256, 1),      # one CTA; nblk below most lengths
]


def _lengths(B, ps, nblk, seed):
    rng = np.random.default_rng(seed)
    n = rng.integers(0, nblk * ps + 2 * ps, size=B)
    n[:2] = [0, nblk * ps - 1][:B]           # an idle slot, the table's end
    return n


@pytest.mark.parametrize("B,ps,nblk,window,chunk,chunks", CASES)
def test_v4_plan_attends_the_jax_list(B, ps, nblk, window, chunk, chunks):
    """The v4 plan's units, slot by slot in list order, cover exactly the
    positions of the JAX list that the mask lets through, each once; a
    slot's units are v2's live chunks (so its bits do not depend on the
    other slots), its runs consecutive places in the list; the CTAs'
    shares are equal, contiguous and no more than ``chunks``."""
    lengths = _lengths(B, ps, nblk, seed=B * 1000 + ps + nblk)
    want = jax_positions(lengths, nblk, ps, window)
    cp = tpaged.paged_chunk_pages(ps, chunk)
    units, share, runs = tpaged.paged_v4_plan(lengths, nblk, ps, window, cp,
                                              chunks)
    got = [[] for _ in lengths]
    for b, blocks in units:
        n = int(lengths[b])
        assert blocks.start // cp == (blocks.stop - 1) // cp   # one chunk
        got[b] += [p for i in blocks for p in range(i * ps, (i + 1) * ps)
                   if p <= n and (window <= 0 or p > n - window)]
    assert got == want
    assert [b for b, _ in units] == sorted(b for b, _ in units)
    for b in range(B):
        r0, count = runs[b]
        assert [u for u in units if u[0] == b] == units[r0:r0 + count]
        assert [r for _, r in units[r0:r0 + count]] == [
            r for r in tpaged.paged_chunk_blocks(int(lengths[b]), nblk, ps,
                                                 window, cp) if len(r)]
    assert share == -(-len(units) // chunks)
    shares = [units[c * share:(c + 1) * share] for c in range(chunks)]
    assert sum(shares, []) == units
    assert all(len(s) == share for s in shares if s is not shares[-1]
               and len(s))


@pytest.mark.parametrize("ps,nblk,window,chunk", [
    (128, 32, 0, 512), (128, 32, 0, 128), (64, 64, 2047, 512),
    (16, 12, 24, 32), (6, 10, 0, 32)])
def test_v2_chunks_attend_the_jax_list(ps, nblk, window, chunk):
    """v2's split over the first nblk blocks walks, for every query
    position, exactly the listed pages of the JAX v4 list that hold a
    position its mask lets through, once each, in block order."""
    cp = tpaged.paged_chunk_pages(ps, chunk)
    lengths = list(range(-1, nblk * ps + ps, max(1, ps // 8)))
    listed = [[] for _ in lengths]
    for b, blk in jax_v4_list([max(n, 0) for n in lengths], nblk, ps):
        listed[b].append(blk)
    for b, n in enumerate(lengths):
        plan = tpaged.paged_chunk_blocks(n, nblk, ps, window, cp)
        assert len(plan) == -(-nblk // cp)
        walked = [i for r in plan for i in r]
        # a listed page's positions are one interval: it holds a position
        # the mask lets through when its first is at or before the query
        # and, with a window, its last is inside the window
        want = [blk for blk in listed[b] if blk * ps <= n
                and (window <= 0 or (blk + 1) * ps - 1 > n - window)]
        assert walked == want


def _inputs(pool: str, B: int = 2, ps: int = 16, hd: int = 64):
    H, KvH, L, P, NBLK = 8, 2, 2, 7, 5
    rows = ps // 2 if pool == "int4" else ps
    if pool == "bf16":
        kp = torch.zeros((L, P, KvH, ps, hd), dtype=torch.bfloat16)
        vp = kp.clone()
    else:
        dtype = torch.uint8 if pool == "int4" else torch.int8
        key = "q4" if pool == "int4" else "q"
        kp, vp = ({key: torch.zeros((L, P, KvH, rows, hd), dtype=dtype),
                   "s": torch.ones((L, P, KvH, ps))} for _ in range(2))
    q = torch.zeros((B, 1, H, hd), dtype=torch.bfloat16)
    tables = torch.arange(B * NBLK, dtype=torch.int32).reshape(B, NBLK) % P
    lengths = torch.tensor([3, 4 * ps + 1] * (B // 2), dtype=torch.int32)
    return q, kp, vp, tables, lengths


def _record(monkeypatch):
    """The card path with the C function replaced by a recorder: returns
    (calls, allocations)."""
    monkeypatch.setattr(cuda_build, "on_card", lambda *t: True)
    for k in ("paged_decode_v2", "paged_decode_v4"):
        monkeypatch.setitem(cuda_build.launches, k, 0)
    calls, allocs = [], []

    def function(lib, symbol, argtypes):
        def fn(*args):
            calls.append((lib, symbol, list(argtypes), args))
            return 0
        return fn
    monkeypatch.setattr(cuda_build, "function", function)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    real_empty = torch.empty

    def empty(*a, **k):
        t = real_empty(*a, **k)
        allocs.append(t)
        return t
    monkeypatch.setattr(torch, "empty", empty)
    return calls, allocs


@pytest.mark.parametrize("pool", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("nblk", [2, 5])
def test_v2_launch_passes_the_chunk_and_one_workspace(pool, nblk,
                                                      monkeypatch):
    """One launch of the pool's v2 entry with the chunk in pages and one
    workspace: acc [B * ceil(nblk / chunk), KvH, G, hd], then (m, l)."""
    calls, allocs = _record(monkeypatch)
    q, kp, vp, tables, lengths = _inputs(pool)
    B, _, H, hd = q.shape
    out = tpaged.paged_decode_attention_v2(q, kp, vp, 1, tables, lengths,
                                           0.125, nblk=nblk)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    [(lib, symbol, argtypes, args)] = calls
    assert (lib, symbol) == ("paged_decode_v2", f"paged_decode_v2_{pool}")
    assert len(argtypes) == len(args) == 24
    assert argtypes[:10] == [ctypes.c_void_p] * 10
    assert argtypes[22:] == [ctypes.c_int, ctypes.c_void_p]
    assert args[10:19] == (B, H, 2, hd, 7, 16, 5, nblk, 1)
    cp = tpaged.paged_chunk_pages(16)
    assert args[22] == cp
    runs = B * -(-nblk // cp)
    [part] = allocs
    assert part.dtype == torch.float32 and part.numel() == runs * H * (hd + 2)
    assert args[8:10] == (part.data_ptr(),
                          part.data_ptr() + 4 * runs * H * hd)
    assert cuda_build.launches["paged_decode_v2"] == 1


@pytest.mark.parametrize("pool", ["int8", "int4", "bf16"])
@pytest.mark.parametrize("B,ctas,chunk", [(2, 4096, 512), (6, 6, 32),
                                          (1024, 64, 512)])
def test_v4_launch_passes_its_ctas_and_one_workspace(pool, B, ctas, chunk,
                                                     monkeypatch):
    """One launch of the pool's v4 entry with the unit's chunk in pages
    and its CTAs a kv head (at most the units there can be), and one
    workspace: acc [B * nunit, KvH, G, hd], (m, l), then each slot's first
    run and run count."""
    calls, allocs = _record(monkeypatch)
    monkeypatch.setattr(tpaged, "PAGED_V4_CTAS", ctas)
    monkeypatch.setattr(tpaged, "PAGED_CHUNK", chunk)
    q, kp, vp, tables, lengths = _inputs(pool, B=B)
    _, _, H, hd = q.shape
    tpaged.paged_decode_attention_v4(q, kp, vp, 1, tables, lengths, 0.125,
                                     nblk=5)
    [(lib, symbol, argtypes, args)] = calls
    assert (lib, symbol) == ("paged_decode_v4", f"paged_decode_v4_{pool}")
    assert len(argtypes) == len(args) == 25
    assert argtypes[:10] == [ctypes.c_void_p] * 10
    assert argtypes[22:] == [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    cp = tpaged.paged_chunk_pages(16)
    nunit = -(-5 // cp)
    chunks = tpaged.paged_v4_chunks(B, 2, nunit)
    assert chunks == max(1, min(ctas // 2, B * nunit))
    assert args[22:24] == (cp, chunks)
    runs = B * nunit
    [part] = allocs
    assert part.numel() == runs * H * (hd + 2) + 2 * B
    assert args[8:10] == (part.data_ptr(),
                          part.data_ptr() + 4 * runs * H * hd)
    assert cuda_build.launches["paged_decode_v4"] == 1


def _no_alloc(monkeypatch):
    def no_alloc(*a, **k):
        raise AssertionError("allocated before refusing")
    monkeypatch.setattr(cuda_build, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_build, "function", None)
    monkeypatch.setattr(torch, "empty", no_alloc)
    monkeypatch.setattr(torch, "empty_like", no_alloc)


def test_v4_refuses_more_than_1024_slots(monkeypatch):
    q, kp, vp, tables, lengths = _inputs("int8", B=1026)
    _no_alloc(monkeypatch)
    with pytest.raises(ValueError, match="at most 1024 slots"):
        tpaged.paged_decode_attention_v4(q, kp, vp, 1, tables, lengths,
                                         0.125, nblk=5)


@pytest.mark.parametrize("route", ["v2", "v4"])
@pytest.mark.parametrize("chunk", [0, -256, 48, 100])
def test_refuses_a_chunk_off_the_tile(route, chunk, monkeypatch):
    q, kp, vp, tables, lengths = _inputs("int8")
    _no_alloc(monkeypatch)
    monkeypatch.setattr(tpaged, "PAGED_CHUNK", chunk)
    fn = getattr(tpaged, f"paged_decode_attention_{route}")
    with pytest.raises(ValueError, match="positive multiple of 32"):
        fn(q, kp, vp, 1, tables, lengths, 0.125, nblk=5)
