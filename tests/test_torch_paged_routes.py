"""The paged-decode routes' contracts and the engine under their knobs,
on the CPU.

- each route's plain version against its Pallas kernel at hd 96 (4 heads
  on 2, window 4), on f32, int8 and int4 pools, within 2e-5 (as
  ``tests/test_torch_paged_variants.py`` at hd 128);
- the nblk contracts: with ``nblk`` below a slot's live pages, the "v2"
  and "v4" plain versions ignore the keys past ``nblk * ps`` and "v3"
  does not, each as its Pallas kernel in interpret mode (within 2e-5);
- the route under the knobs, the serving default under ``TPU_PAGED_V3=0``
  (MHA dense, GQA paged, as the JAX ``resolve_paged_default``) and the
  engine's refusal of a pool no kernel on the card takes;
- the engine's greedy streams on the paged pool under each route equal
  the dense engine's on the tiny preset with a window that bites, f32
  and int8 caches (as the JAX ``test_paged_v{3,4}_engine_matches_dense``).
"""

import dataclasses

import numpy as np
import pytest
import torch
from test_torch_paged_variants import (check_plain_matches_pallas,
                                       jax_paged, paged_inputs, port_paged,
                                       set_knobs)

from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.ops import paged as tpaged
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      PagedCache,
                                                      SlotOptions,
                                                      resolve_paged_default)

torch.set_num_threads(1)

@pytest.mark.parametrize("pool", ["f32", "int8", "int4"])
@pytest.mark.parametrize("route", ["v2", "v3", "v4"])
def test_paged_plain_matches_pallas_hd96(route, pool, monkeypatch):
    check_plain_matches_pallas(route, pool, 2, 4, 96, 4, monkeypatch)


@pytest.mark.parametrize("pool,window", [
    ("f32", 0), ("int8", 11), ("int4", 0), ("int4", 11)])
def test_nblk_contracts(pool, window, monkeypatch):
    """nblk = 2 while slot 3 has 4 live pages: v2 and v4 attend its first
    2 blocks only, v3 every live page of the table; each route's plain
    version matches its own Pallas kernel, and slot 3 tells them apart."""
    q, kp, vp, tables = paged_inputs(7, 2, 8, 128, pool)
    scale = 128 ** -0.5
    out = {}
    for route in ("v2", "v3", "v4"):
        j = jax_paged(route, q, kp, vp, tables, scale, window, 2,
                      monkeypatch)
        t = port_paged(route, q, kp, vp, tables, scale, window, 2,
                       monkeypatch)
        np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5,
                                   err_msg=route)
        out[route] = t
    np.testing.assert_allclose(out["v2"], out["v4"], rtol=2e-5, atol=2e-5)
    # slots 0-2 lie inside 2 blocks: all routes agree there
    np.testing.assert_allclose(out["v2"][:3], out["v3"][:3], rtol=2e-5,
                               atol=2e-5)
    # slot 3 (position 29): v3 attends keys 16..29 too; with window 11 the
    # truncated routes find no key in range at all and give 0
    assert np.abs(out["v2"][3] - out["v3"][3]).max() > 1e-2
    if window:
        assert not out["v2"][3].any()


def test_paged_route_follows_the_knobs(monkeypatch):
    for k in ("TPU_PAGED_V3", "TPU_PAGED_V4"):
        monkeypatch.delenv(k, raising=False)
    assert tpaged.paged_route() == "v3"
    for v3, v4, route in (("1", "0", "v3"), ("0", "0", "v2"),
                          ("", "0", "v2"), ("0", "1", "v4"),
                          ("1", "1", "v4"), ("1", "true", "v3")):
        monkeypatch.setenv("TPU_PAGED_V3", v3)
        monkeypatch.setenv("TPU_PAGED_V4", v4)
        assert tpaged.paged_route() == route, (v3, v4)


def test_resolve_paged_default_under_the_v3_knob(monkeypatch):
    """The JAX ``resolve_paged_default``'s rule on the card: MHA pages
    unless v3 is reverted; GQA pages either way; MoE and the CPU stay
    dense."""
    monkeypatch.delenv("TPU_PAGED_V3", raising=False)
    gqa = TPRESETS["tiny"]
    mha = dataclasses.replace(gqa, n_kv_heads=gqa.n_heads)
    assert resolve_paged_default(gqa, "cuda") is True
    assert resolve_paged_default(mha, "cuda") is True
    assert resolve_paged_default(gqa, "cpu") is False
    monkeypatch.setenv("TPU_PAGED_V3", "0")
    assert resolve_paged_default(mha, "cuda") is False
    assert resolve_paged_default(gqa, "cuda") is True
    assert resolve_paged_default(TPRESETS["phi3"], "cuda") is False
    assert resolve_paged_default(TPRESETS["llama3.1"], "cuda") is True
    monkeypatch.setenv("TPU_PAGED_V4", "1")      # v4 does not bring MHA back
    assert resolve_paged_default(mha, "cuda") is False
    monkeypatch.delenv("TPU_PAGED_V3")
    moe = dataclasses.replace(gqa, n_experts=4)
    assert resolve_paged_default(moe, "cuda") is False


@pytest.mark.parametrize("over,ps,dtype,why", [
    ({"n_heads": 32, "n_kv_heads": 2}, 64, torch.int8, "group"),
    ({"head_dim": 18}, 64, torch.int8, "hd=18"),
    ({"head_dim": 264}, 64, torch.bfloat16, "hd=264"),
    ({}, 256, torch.int8, "page size 256"),
])
def test_card_refuses_pools_no_kernel_takes(over, ps, dtype, why):
    """Built for the card, a paged cache the paged-decode kernels cannot
    take is refused at construction (before anything is allocated);
    the CPU's plain version takes it."""
    cfg = dataclasses.replace(TPRESETS["tiny"], **over)
    with pytest.raises(ValueError, match=why):
        PagedCache(cfg, 2, 256, ps, 4, dtype, torch.device("cuda"))
    PagedCache(cfg, 2, 256, ps, 4, dtype, torch.device("cpu"))


def test_limits_are_the_kernels():
    assert tpaged.paged_shape_error(32, 8, 128, 128, False) is None
    assert tpaged.paged_shape_error(32, 32, 96, 64, True) is None
    assert tpaged.paged_shape_error(24, 8, 128, 128, True) is None
    assert tpaged.paged_shape_error(8, 8, 256, 2, True) is None
    assert tpaged.paged_shape_error(8, 3, 64, 8, False)          # H % KvH
    assert tpaged.paged_shape_error(18, 2, 64, 8, False)         # G = 9
    assert tpaged.paged_shape_error(8, 8, 64, 7, True)           # odd int4


ECFG = dict(max_slots=4, max_seq_len=64, min_prefill_bucket=16,
            decode_chunk=4)
PROMPT = np.array([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7], np.int32)
P2 = np.array([7, 7, 7], np.int32)


def greedy_run(cfg, params, ecfg):
    eng = Engine(cfg, params, ecfg, device="cpu")
    greedy = SlotOptions(temperature=0)
    seq = [eng.admit(0, PROMPT, greedy)]
    seq += eng.decode_n_launch(4).wait()[:, 0].tolist()
    seq.append(eng.admit(1, P2, greedy))
    for _ in range(3):
        seq += eng.decode_n_launch(4).wait()[:, :2].ravel().tolist()
    return seq


@pytest.mark.parametrize("kv", ["float32", "int8"])
@pytest.mark.parametrize("route", ["v2", "v3", "v4"])
def test_paged_engine_matches_dense_under_each_route(route, kv,
                                                     monkeypatch):
    """The engine's greedy stream on the paged pool (page 8) under the
    route's knobs equals the dense engine's, a window of 8 biting on the
    14-token prompt."""
    cfg = dataclasses.replace(TPRESETS["tiny"], sliding_window=8)
    gen = torch.Generator(device="cpu").manual_seed(5)
    params = tdec.init_params(cfg, gen, torch.float32, "cpu")
    dtype = getattr(torch, kv)
    set_knobs(monkeypatch, route)
    dense = greedy_run(cfg, params, EngineConfig(paged=False,
                                                 cache_dtype=dtype, **ECFG))
    paged = greedy_run(cfg, params, EngineConfig(paged=True, page_size=8,
                                                 cache_dtype=dtype, **ECFG))
    assert paged == dense
