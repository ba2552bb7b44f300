"""The v3 paged-decode kernel's split over chunks of pages
(``ollama_operator_tpu_torch/ops/paged.py``, ``csrc/paged_decode.cu``).

The kernel itself runs only on the card (``chip_smoke.py`` holds it against
``paged_decode_attention_plain(route="v3")``); here, on the CPU:

- the chunk plan (:func:`paged_chunk_blocks`, the Python statement of the
  kernel's row ranges) walks every live page of v3's contract exactly once,
  in block order, whatever the page size, window and chunk;
- the wrapper refuses a chunk off the kernel's 32-position tile before it
  builds or allocates anything;
- the wrapper's launch on the card path (its C function replaced by a
  recorder): the arguments it passes and its one workspace allocation.
"""

from __future__ import annotations

import ctypes
import types

import pytest
import torch

from ollama_operator_tpu_torch.ops import cuda_build
from ollama_operator_tpu_torch.ops import paged as tpaged

torch.set_num_threads(1)


def live_blocks(length: int, NBLK: int, ps: int, window: int):
    """The blocks v3 attends for a query at ``length``, from its mask: a
    block of the table holding a position p with p <= length and, with a
    window, p > length - window."""
    return [i for i in range(NBLK)
            if any(p <= length and (window <= 0 or p > length - window)
                   for p in range(i * ps, (i + 1) * ps))]


@pytest.mark.parametrize("ps,NBLK,window,chunk", [
    (128, 32, 0, 512),     # llama paths: 4 pages a chunk
    (128, 32, 0, 256),     # the neighbouring chunks
    (128, 32, 0, 1024),
    (64, 64, 2047, 512),   # phi3: 8 pages a chunk, the window bites
    (16, 12, 24, 32),      # a window inside a chunk
    (6, 10, 0, 32),        # pages that do not divide the chunk (5 a chunk)
    (128, 5, 200, 32),     # a chunk below one page: one page a chunk
])
def test_v3_chunks_cover_every_live_page_once(ps, NBLK, window, chunk):
    """For every query position, past the table's end included, the chunks
    (a count that depends on NBLK and the chunk alone) hold v3's live
    blocks each exactly once, in block order, pages past any ``nblk``
    included; a chunk past the query or before the window holds none."""
    cp = tpaged.paged_chunk_pages(ps, chunk)
    assert cp == max(1, chunk // ps)
    n_chunks = -(-NBLK // cp)
    for length in range(-1, NBLK * ps + ps):
        plan = tpaged.paged_chunk_blocks(length, NBLK, ps, window, cp)
        assert len(plan) == n_chunks
        walked = [i for r in plan for i in r]
        assert walked == live_blocks(length, NBLK, ps, window)
        lo = max(0, length - window + 1) if window > 0 else 0
        for z, r in enumerate(plan):
            assert all(z * cp <= i < (z + 1) * cp for i in r)
            if z * cp * ps > length or (z + 1) * cp * ps <= lo:
                assert not len(r)


def _inputs(pool: str, ps: int, hd: int = 64):
    B, H, KvH, L, P, NBLK = 2, 8, 2, 2, 7, 5
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
    lengths = torch.tensor([3, 4 * ps + 1], dtype=torch.int32)
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("chunk", [0, -256, 48, 100])
def test_v3_refuses_a_chunk_off_its_tile(chunk, monkeypatch):
    """On the card the v3 wrapper splits each slot's pages in chunks of
    ``PAGED_CHUNK`` positions, a positive multiple of the kernel's
    32-position tile, and raises on any other chunk before it builds,
    allocates or launches anything."""
    monkeypatch.setattr(cuda_build, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_build, "function", None)
    monkeypatch.setattr(tpaged, "PAGED_CHUNK", chunk)
    q, kp, vp, tables, lengths = _inputs("int8", 16)

    def no_alloc(*a, **k):
        raise AssertionError("allocated before refusing the chunk")
    monkeypatch.setattr(torch, "empty", no_alloc)
    monkeypatch.setattr(torch, "empty_like", no_alloc)
    with pytest.raises(ValueError, match="positive multiple of 32"):
        tpaged.paged_decode_attention_v3(q, kp, vp, 1, tables, lengths,
                                         0.125, nblk=1)


@pytest.mark.parametrize("pool,ps,chunk_pages", [
    ("int8", 128, 4), ("int4", 128, 4), ("bf16", 128, 4),
    ("int8", 64, 8), ("int4", 6, 85)])
def test_v3_launch_passes_the_chunk_and_one_workspace(pool, ps, chunk_pages,
                                                      monkeypatch):
    """The card path of the v3 wrapper, with the C function replaced by a
    recorder: one launch of the pool's entry of ``paged_decode`` with the
    chunk in pages and both partial tensors in one workspace allocation
    (acc [B * nchunk, KvH, G, hd], then (m, l)), counted once under the
    pool's counter."""
    monkeypatch.setattr(cuda_build, "on_card", lambda *t: True)
    monkeypatch.setitem(cuda_build.launches, "paged_decode", 0)
    monkeypatch.setitem(cuda_build.launches, "paged_decode_int4", 0)
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
    q, kp, vp, tables, lengths = _inputs(pool, ps)
    B, _, H, hd = q.shape
    KvH, NBLK = 2, tables.shape[1]
    out = tpaged.paged_decode_attention_v3(q, kp, vp, 1, tables, lengths,
                                           0.125, nblk=1)
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    [(lib, symbol, argtypes, args)] = calls
    assert (lib, symbol) == ("paged_decode", f"paged_decode_{pool}")
    assert len(argtypes) == len(args) == 24
    assert argtypes[:10] == [ctypes.c_void_p] * 10
    assert argtypes[22:] == [ctypes.c_int, ctypes.c_void_p]
    assert args[10:19] == (B, H, KvH, hd, 7, ps, NBLK, 1, 1)
    assert args[22] == chunk_pages == tpaged.paged_chunk_pages(ps)
    runs = B * -(-NBLK // chunk_pages)
    [part] = allocs
    assert part.dtype == torch.float32 and part.numel() == runs * H * (hd + 2)
    assert args[8] == part.data_ptr()
    assert args[9] == part.data_ptr() + 4 * runs * H * hd
    counter = "paged_decode_int4" if pool == "int4" else "paged_decode"
    assert cuda_build.launches[counter] == 1
