"""The port's three paged-decode routes against the JAX package's three
paged kernels, on the CPU: the plain version of each route against its
Pallas kernel in interpret mode.

- "v2" (``TPU_PAGED_V3=0``) against the JAX dispatcher with
  ``TPU_PAGED_V3=0`` and ``TPU_PAGED_V4=0`` (its v2 grid kernel), "v4"
  (``TPU_PAGED_V4=1``) against ``paged_decode_attention_v4`` and "v3" (the
  default) against ``paged_decode_attention_v3``, each through the port's
  dispatcher ``paged_decode_attention`` under the same knobs;
- f32, int8 and int4 pools; GQA (8 heads on 2, window 0) and MHA (4 on
  4, window 11) at hd 128 (hd 96 in ``tests/test_torch_paged_routes.py``);
  slot lengths 0, 3, 12 and 29 at page size 8 (1, 1, 2 and 4 live pages);
- within 2e-5, the JAX suite's own tolerance for v2/v3/v4 (f32 softmax
  sums taken in another order).

The nblk contracts, the route and the engine under the knobs are in
``tests/test_torch_paged_routes.py``; the bf16 cases of the three routes
in ``tests/test_torch_rounding.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.ops.pallas import paged as jpaged
from ollama_operator_tpu_torch.ops import paged as tpaged

torch.set_num_threads(1)

KNOBS = {"v2": {"TPU_PAGED_V3": "0", "TPU_PAGED_V4": "0"},
         "v3": {"TPU_PAGED_V3": "1", "TPU_PAGED_V4": "0"},
         "v4": {"TPU_PAGED_V3": "1", "TPU_PAGED_V4": "1"}}
LENGTHS = np.array([0, 3, 12, 29], np.int32)   # 1, 1, 2 and 4 live pages
L, P, PS, NBLK = 2, 9, 8, 4


def set_knobs(monkeypatch, route):
    for k, v in KNOBS[route].items():
        monkeypatch.setenv(k, v)


def paged_inputs(seed, kvh, h, hd, pool):
    """q [4, 1, h, hd] f32 and two pools of ``pool`` kind ("f32", "int8",
    "int4") [L, P, kvh, 8, hd]; every slot's live pages are distinct pages
    1..8 in a shuffled order (8 in all), dead table entries 0."""
    rng = np.random.default_rng(seed)
    tables = np.zeros((len(LENGTHS), NBLK), np.int32)
    pages = rng.permutation(np.arange(1, P))
    for b, n in enumerate(LENGTHS // PS + 1):
        tables[b, :n], pages = pages[:n], pages[n:]
    q = rng.standard_normal((len(LENGTHS), 1, h, hd)).astype(np.float32)

    def one():
        shape = (L, P, kvh, PS, hd)
        if pool == "f32":
            return rng.standard_normal(shape).astype(np.float32)
        s = rng.uniform(0.01, 0.05, shape[:-1]).astype(np.float32)
        if pool == "int8":
            return {"q": rng.integers(-127, 128, shape).astype(np.int8),
                    "s": s}
        return {"q4": rng.integers(0, 256, shape[:3] + (PS // 2, hd)
                                   ).astype(np.uint8), "s": s}
    return q, one(), one(), tables


def to_jax(pool):
    if not isinstance(pool, dict):
        return jnp.asarray(pool)
    # the JAX int4 pool holds the same bytes as int8
    return {k: jnp.asarray(v.view(np.int8) if k == "q4" else v)
            for k, v in pool.items()}


def to_torch(pool):
    if not isinstance(pool, dict):
        return torch.tensor(pool)
    return {k: torch.tensor(v) for k, v in pool.items()}


def jax_paged(route, q, kp, vp, tables, scale, window, nblk, monkeypatch):
    args = (jnp.asarray(q), to_jax(kp), to_jax(vp), jnp.int32(1),
            jnp.asarray(tables), jnp.asarray(LENGTHS), scale, 0.0, window)
    if route == "v2":
        set_knobs(monkeypatch, "v2")
        out = jpaged.paged_decode_attention(*args, nblk=nblk, interpret=True)
    else:
        fn = (jpaged.paged_decode_attention_v3 if route == "v3"
              else jpaged.paged_decode_attention_v4)
        out = fn(*args, nblk=nblk, interpret=True)
    assert out is not None
    return np.asarray(out)


def port_paged(route, q, kp, vp, tables, scale, window, nblk, monkeypatch):
    set_knobs(monkeypatch, route)
    assert tpaged.paged_route() == route
    return tpaged.paged_decode_attention(
        torch.tensor(q), to_torch(kp), to_torch(vp), 1,
        torch.tensor(tables), torch.tensor(LENGTHS), scale, 0.0, window,
        nblk=nblk).numpy()


def check_plain_matches_pallas(route, pool, kvh, h, hd, window,
                               monkeypatch):
    """The route's plain version against its Pallas kernel, with nblk
    covering every slot."""
    q, kp, vp, tables = paged_inputs(hd + h + kvh, kvh, h, hd, pool)
    scale = hd ** -0.5
    j = jax_paged(route, q, kp, vp, tables, scale, window, NBLK,
                  monkeypatch)
    t = port_paged(route, q, kp, vp, tables, scale, window, NBLK,
                   monkeypatch)
    np.testing.assert_allclose(t, j, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("kvh,h,window", [(2, 8, 0), (4, 4, 11)])
@pytest.mark.parametrize("pool", ["f32", "int8", "int4"])
@pytest.mark.parametrize("route", ["v2", "v3", "v4"])
def test_paged_plain_matches_pallas(route, pool, kvh, h, window,
                                    monkeypatch):
    check_plain_matches_pallas(route, pool, kvh, h, 128, window, monkeypatch)
