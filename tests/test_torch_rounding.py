"""Where the port rounds the attention probabilities to bf16, against the
JAX package, on bf16 inputs on the CPU (f32 tests cannot see a bf16
rounding, and the card's 1% kernel checks cannot either).

- ``attend_hf`` against the JAX ``attend_hf``: the normalised
  probabilities rounded to v's dtype before the p . v product;
- ``flash_prefill_plain`` against the Pallas ``flash_prefill`` in
  interpret mode: p = exp(s - row max) rounded to bf16 before the p . v
  product, the sum l unrounded (one key block covers the chunk there);
- the paged plain version of each route ("v2", "v3", "v4") on bf16, int8
  and int4 pools against its Pallas kernel in interpret mode: p (times the
  value scale) from the running max, page by page, rounded to bf16.

Each holds the bf16 outputs to the rule of ``tests/test_torch_dense.py``:
at most 2% of them may differ (an f32 sum taken in another order landing
across a bf16 rounding boundary), none by more than 2^-7 x max |out| (one
bf16 ulp of the largest output). Keeping p in f32 instead makes 10-50% of
the outputs differ here.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.ops import attention as jattn
from ollama_operator_tpu.ops.pallas import paged as jpaged
from ollama_operator_tpu.ops.pallas.flash import flash_prefill as jflash
from ollama_operator_tpu_torch.ops import attention as tattn
from ollama_operator_tpu_torch.ops import paged as tpaged

torch.set_num_threads(1)


def bf16_pair(a):
    """A float array → the same bf16 values as a JAX and a torch array."""
    t = torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def assert_bf16_matches(t, j):
    t = t.float().numpy()
    j = np.asarray(j.astype(jnp.float32))
    assert t.shape == j.shape
    share = np.mean(t != j)
    assert share <= 0.02, f"{share:.1%} of outputs differ"
    np.testing.assert_allclose(t, j, rtol=0, atol=2 ** -7 * np.abs(j).max())


@pytest.mark.parametrize("G", [1, 3])
def test_attend_hf_rounds_like_jax(G):
    rng = np.random.default_rng(500 + G)
    B, T, KvH, S, hd = 2, 4, 2, 64, 32
    jq, tq = bf16_pair(rng.standard_normal((B, T, KvH * G, hd)))
    jk, tk = bf16_pair(rng.standard_normal((B, KvH, S, hd)))
    jv, tv = bf16_pair(rng.standard_normal((B, KvH, S, hd)))
    # query t of row b sits at position p_b + t: row 0 early, row 1 last
    q_pos = np.array([9, S - T])[:, None] + np.arange(T)
    mask = np.where(np.arange(S) <= q_pos[..., None], 0.0, -1e30
                    ).astype(np.float32)[:, None]
    j = jattn.attend_hf(jq, jk, jv, jnp.asarray(mask), hd ** -0.5)
    t = tattn.attend_hf(tq, tk, tv, torch.tensor(mask), hd ** -0.5)
    assert t.dtype == torch.bfloat16
    assert_bf16_matches(t, j)


@pytest.mark.parametrize("window", [0, 32])
@pytest.mark.parametrize("H,KvH", [(4, 4), (8, 2)])
def test_flash_prefill_plain_rounds_like_pallas(H, KvH, window):
    rng = np.random.default_rng(600 + H + window)
    B, T, hd = 2, 128, 64
    jq, tq = bf16_pair(rng.standard_normal((B, T, H, hd)))
    jk, tk = bf16_pair(rng.standard_normal((B, KvH, T, hd)))
    jv, tv = bf16_pair(rng.standard_normal((B, KvH, T, hd)))
    j = jflash(jq, jk, jv, hd ** -0.5, 0.0, window, interpret=True)
    t = tattn.flash_prefill(tq, tk, tv, hd ** -0.5, 0.0, window)
    assert t.dtype == torch.bfloat16
    assert_bf16_matches(t, j)


LENGTHS = np.array([0, 21, 70, 127], np.int32)  # 1, 2, 5 and 8 live pages
PS, NBLK = 16, 8


def paged_bf16_inputs(rng, pool, kvh=2, h=6, hd=64):
    """bf16 q [4, 1, h, hd] and two pools of ``pool`` kind ("bf16", "int8",
    "int4") [1, 17, kvh, 16, hd], as (JAX, torch) pairs; tables [4, 8]
    over distinct shuffled pages."""
    n_live = LENGTHS // PS + 1
    P = int(n_live.sum()) + 1
    tables = np.zeros((len(LENGTHS), NBLK), np.int32)
    pages = rng.permutation(np.arange(1, P))
    for b, n in enumerate(n_live):
        tables[b, :n], pages = pages[:n], pages[n:]
    q = bf16_pair(rng.standard_normal((len(LENGTHS), 1, h, hd)))

    def one():
        shape = (1, P, kvh, PS, hd)
        if pool == "bf16":
            return bf16_pair(rng.standard_normal(shape))
        s = rng.uniform(0.01, 0.05, shape[:-1]).astype(np.float32)
        if pool == "int8":
            c = rng.integers(-127, 128, shape).astype(np.int8)
            return ({"q": jnp.asarray(c), "s": jnp.asarray(s)},
                    {"q": torch.tensor(c), "s": torch.tensor(s)})
        c = rng.integers(0, 256, shape[:3] + (PS // 2, hd)).astype(np.uint8)
        return ({"q4": jnp.asarray(c.view(np.int8)), "s": jnp.asarray(s)},
                {"q4": torch.tensor(c), "s": torch.tensor(s)})
    return q, one(), one(), tables


@pytest.mark.parametrize("pool", ["bf16", "int8", "int4"])
@pytest.mark.parametrize("route", ["v2", "v3", "v4"])
def test_paged_plain_rounds_like_pallas(route, pool, monkeypatch):
    rng = np.random.default_rng(700 + len(pool) + len(route))
    (jq, tq), (jk, tk), (jv, tv), tables = paged_bf16_inputs(rng, pool)
    window = 40 if route == "v3" else 0
    args = (jnp.int32(0), jnp.asarray(tables), jnp.asarray(LENGTHS),
            64 ** -0.5, 0.0, window)
    monkeypatch.setenv("TPU_PAGED_V3", "0" if route == "v2" else "1")
    monkeypatch.setenv("TPU_PAGED_V4", "1" if route == "v4" else "0")
    jfn = {"v2": jpaged.paged_decode_attention,
           "v3": jpaged.paged_decode_attention_v3,
           "v4": jpaged.paged_decode_attention_v4}[route]
    j = jfn(jq, jk, jv, *args, nblk=NBLK, interpret=True)
    assert j is not None
    t = tpaged.paged_decode_attention(
        tq, tk, tv, 0, torch.tensor(tables), torch.tensor(LENGTHS),
        64 ** -0.5, 0.0, window, nblk=NBLK)
    assert t.dtype == torch.bfloat16
    assert_bf16_matches(t, j)
