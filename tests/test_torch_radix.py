"""The port's radix prefix cache, on the CPU at the tiny preset.

- the port's copy of ``RadixCache``: match, insert, LRU eviction page by
  page, reset, as the JAX package's tests hold them;
- ``Engine.stitch`` with full pages and a copy-on-write boundary page
  against the JAX ``Engine.stitch`` on the same calls (int8 pool, and
  the int4 pool with an odd boundary): the same reuse, the same first
  token and decode stream, which is also the port's cold admission's;
  the shared pages' bytes are unchanged after the tail is written;
- the scheduler: concurrent requests hit one donated prefix with the
  cold streams, ``TPU_MIN_PREFIX_REUSE`` floors the reuse, LRU eviction
  keeps a small pool serving, and a dry pool at the copy-on-write page
  falls back to a cold admission with the same stream.

``PageTable.check()`` runs after every case.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.runtime.engine import Engine as JEngine
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import SlotOptions as JSlotOptions
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime import paged as tpaged
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)
from ollama_operator_tpu_torch.runtime.paged import live_tables
from ollama_operator_tpu_torch.runtime.radix import RadixCache
from ollama_operator_tpu_torch.runtime.scheduler import Scheduler

torch.set_num_threads(1)

JCFG = dataclasses.replace(JPRESETS["tiny"], kernels="xla")
TCFG = TPRESETS["tiny"]
PS = 8
GREEDY = dict(temperature=0.0)
PREFIX = np.arange(1, 25)                      # 24 tokens = 3 pages
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2, 6])


@pytest.fixture(autouse=True)
def _port_page_accounting():
    yield
    for pt in live_tables():
        pt.check()


@pytest.fixture(scope="module")
def params():
    p = jdec.init_params(JCFG, jax.random.key(0), jnp.float32)
    npp = jax.tree_util.tree_map(np.asarray, p)
    return p, params_from_numpy(npp, device="cpu")


def port_engine(params, cache=torch.float32, **kw):
    ecfg = dict(max_slots=4, max_seq_len=64, cache_dtype=cache,
                min_prefill_bucket=16, paged=True, page_size=PS,
                decode_chunk=4)
    ecfg.update(kw)
    return Engine(TCFG, params[1], EngineConfig(**ecfg), device="cpu")


def decode(eng, slot, n):
    out = []
    for _ in range(n):
        h = eng.decode_n_launch(1)
        out.append(int(h.wait()[0, slot]))
        eng.retire(h.epoch)
    return out


def drain(sched, deadline_s=10.0):
    t1 = time.monotonic() + deadline_s
    while sched.has_pending and time.monotonic() < t1:
        time.sleep(0.01)
    assert not sched.has_pending


# ---------------------------------------------------------------------------
# the tree (no engine)
# ---------------------------------------------------------------------------

def test_radix_match_insert_evict_lru():
    rc = RadixCache(page_size=4)
    ids = list(range(1, 13))                   # 3 chunks
    assert [n.page for n in rc.insert(ids, [10, 11, 12])] == [10, 11, 12]
    assert rc.n_nodes == 3 and rc.n_pages == 3
    assert rc.insert(ids, [20, 21, 22]) == []  # dedup keeps tree pages
    full, part, q = rc.match(ids + [99], 12, bump=False)
    assert [n.page for n in full] == [10, 11, 12] and part is None and q == 0
    # partial boundary: 6 shared tokens = 1 full chunk + 2 into the next
    full, part, q = rc.match(ids[:6] + [77, 78], 8)
    assert [n.page for n in full] == [10] and part.page == 11 and q == 2
    assert all(n.tier == 0 for n in full)
    # LRU: a second branch, then bump the first -> branch leaf is oldest
    assert [n.page for n in rc.insert(ids[:4] + [50, 51, 52, 53], [13, 14])
            ] == [14]
    rc.match(ids, 12)
    assert rc.evict(1, lambda pg: True) == [14]
    # page by page: children leave before parents; unevictable pages stay
    assert rc.evict(10, lambda pg: pg != 10) == [12, 11]
    assert rc.evict(10, lambda pg: True) == [10]
    assert rc.n_nodes == 0
    rc.insert(ids, [10, 11, 12])
    assert sorted(rc.reset()) == [10, 11, 12] and rc.n_nodes == 0


# ---------------------------------------------------------------------------
# engine: stitch against the JAX engine's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind,tail", [("int8", [60, 61, 62]),
                                       ("int4", [77, 78, 79, 80, 81])])
def test_stitch_matches_jax_and_cold(params, kind, tail):
    """A donor's 28-token prompt and 5 decoded tokens leave 4 full pages
    in the tree; a request that diverges 3 tokens into page 3 (an odd
    boundary: the tail's first int4 code shares a byte with the prefix's
    last) stitches 3 shared pages and a copy-on-write page. Reuse, first
    token and decode stream equal the JAX engine's on the same calls and
    the port's cold admission; the shared pages are unchanged."""
    jdt, tdt = {"int8": (jnp.int8, torch.int8),
                "int4": ("int4", "int4")}[kind]
    je = JEngine(JCFG, params[0], ecfg=JEngineConfig(
        max_slots=4, max_seq_len=64, cache_dtype=jdt, min_prefill_bucket=16,
        paged=True, page_size=PS))
    te = port_engine(params, cache=tdt, decode_chunk=1)
    assert je.radix_enabled and te.radix_enabled
    donor = np.arange(1, 29)
    div = np.concatenate([donor[:27], tail])
    out = {}
    for name, eng, opts in (("jax", je, JSlotOptions(**GREEDY)),
                            ("port", te, SlotOptions(**GREEDY))):
        first = eng.admit(0, donor.astype(np.int32), opts)
        toks = [first] + ([int(eng.decode()[0]) for _ in range(5)]
                          if name == "jax" else decode(eng, 0, 5))
        assert eng.donate_prefix(0, list(donor) + toks[:-1]) == 32
        assert eng.radix_pages == 4
        want = eng.prefix_probe(div)
        assert want == 27                # 3 full pages + 3 into page 3
        got = eng.stitch(0, div.astype(np.int32), want)
        if name == "port":
            shared = eng._pt.slot_pages(0)[:3]
            leaves = list(eng.k_cache.values()) + list(eng.v_cache.values())
            before = [t[:, shared].clone() for t in leaves]
        first = eng.extend(0, div.astype(np.int32), got, opts)
        toks = [first] + ([int(eng.decode()[0]) for _ in range(3)]
                          if name == "jax" else decode(eng, 0, 3))
        if name == "port":
            for t, b in zip(leaves, before):
                assert torch.equal(t[:, shared], b)
        eng.release(0)
        out[name] = (got, toks)
    assert out["port"] == out["jax"]
    cold_eng = port_engine(params, cache=tdt, decode_chunk=1)
    cold = [cold_eng.admit(1, div, SlotOptions(**GREEDY))] + decode(
        cold_eng, 1, 3)
    assert out["port"][1] == cold
    te._pt.check()
    assert te._pt.n_free == te._pt.data_pages - te.radix_pages


# ---------------------------------------------------------------------------
# scheduler
# ---------------------------------------------------------------------------

def test_scheduler_radix_hits_shared_prefix_concurrently(params):
    """Requests sharing a donated prefix all stitch it, concurrently, and
    their streams equal cold admissions'."""
    cold = {}
    full2 = np.concatenate([PREFIX, [90, 91]])
    full = np.concatenate([PREFIX, [70, 71, 72]])
    for f in (full, full2):
        eng = port_engine(params)
        sched = Scheduler(eng)
        try:
            r = sched.submit(f, SlotOptions(**GREEDY), max_tokens=4)
            cold[len(f)] = list(r.tokens())
            assert r.stats.n_reused == 0
        finally:
            sched.shutdown()
    eng = port_engine(params)
    sched = Scheduler(eng)
    try:
        out1 = list(sched.submit(full, SlotOptions(**GREEDY),
                                 max_tokens=4).tokens())
        assert out1 == cold[len(full)]
        drain(sched)
        assert eng.radix_pages == 3           # the full pages donated
        r2 = sched.submit(full, SlotOptions(**GREEDY), max_tokens=4)
        r3 = sched.submit(full2, SlotOptions(**GREEDY), max_tokens=4)
        assert list(r2.tokens()) == cold[len(full)]
        assert list(r3.tokens()) == cold[len(full2)]
        assert r2.stats.n_reused >= 16 and r3.stats.n_reused >= 16
        drain(sched)
        assert eng._pt.n_free == eng._pt.data_pages - eng.radix_pages
    finally:
        sched.shutdown()


def test_min_prefix_reuse_env_knob(params, monkeypatch):
    monkeypatch.setenv("TPU_MIN_PREFIX_REUSE", "48")
    eng = port_engine(params)
    sched = Scheduler(eng)
    try:
        assert sched.min_prefix_reuse == 48
        full = np.concatenate([PREFIX, [70, 71]])
        list(sched.submit(full, SlotOptions(**GREEDY), max_tokens=4
                          ).tokens())
        r2 = sched.submit(full, SlotOptions(**GREEDY), max_tokens=4)
        list(r2.tokens())
        assert r2.stats.n_reused == 0         # 25 matchable < 48 floor
    finally:
        sched.shutdown()


def test_radix_lru_eviction_under_pressure(params):
    """A pool smaller than the working set: donations pin pages until
    admissions run dry, eviction trims LRU leaves page by page, and every
    request finishes with its full budget."""
    eng = port_engine(params, max_slots=2, n_pages=8)
    sched = Scheduler(eng)
    try:
        for i in range(4):
            prompt = np.arange(1 + 20 * i, 17 + 20 * i)
            r = sched.submit(prompt, SlotOptions(**GREEDY), max_tokens=4)
            assert len(list(r.tokens())) == 4
        drain(sched)
        assert 0 < eng.radix_pages <= 6
        assert eng._pt.n_free == eng._pt.data_pages - eng.radix_pages
    finally:
        sched.shutdown()


def test_refcounts_across_preempt_readmit(params):
    eng = port_engine(params, max_slots=3, n_pages=6)
    sched = Scheduler(eng)
    try:
        reqs = [sched.submit(PROMPT + i, SlotOptions(**GREEDY),
                             max_tokens=12) for i in range(3)]
        for r in reqs:
            assert len(list(r.tokens())) == 12
        assert sched.n_preempted >= 1
        drain(sched)
        assert eng._pt.n_free == eng._pt.data_pages - eng.radix_pages
    finally:
        sched.shutdown()


def test_dry_pool_mid_stitch_falls_back_cold(params, monkeypatch):
    """The copy-on-write page finds the pool dry once (the allocation
    fails, as the JAX package's ``pages.alloc`` fault makes it): the
    admission falls back to a cold prefill with the same stream, and no
    page leaks."""
    eng = port_engine(params)
    sched = Scheduler(eng)
    try:
        full = np.concatenate([PREFIX, [70, 71, 72]])
        out1 = list(sched.submit(full, SlotOptions(**GREEDY),
                                 max_tokens=4).tokens())
        drain(sched)
        assert eng.prefix_probe(full) >= 16
        real = tpaged.PageTable.grow
        armed = [True]

        def grow_once_dry(self, slot, n_tokens):
            if armed[0]:
                armed[0] = False
                return False
            return real(self, slot, n_tokens)
        monkeypatch.setattr(tpaged.PageTable, "grow", grow_once_dry)
        r2 = sched.submit(full, SlotOptions(**GREEDY), max_tokens=4)
        assert list(r2.tokens()) == out1
        assert not armed[0]
        assert r2.stats.n_reused == 0          # it really went cold
        drain(sched)
        assert eng._pt.n_free == eng._pt.data_pages - eng.radix_pages
    finally:
        sched.shutdown()
