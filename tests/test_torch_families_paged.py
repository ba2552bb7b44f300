"""The port's paged forward on the JAX package's other dense families.

The families, weights and tolerance of ``tests/test_torch_families.py``:
``paged_insert``, a chunked extend at T > 1 through
``forward_with_cache_paged`` and batched decode steps at T = 1, on an
int8 pool and on a dense pool (f32 here; bf16 on the card), against the
JAX paged forward with its Pallas paged-decode kernel in interpret mode
(the alternating archs take its gather + einsum, as the port's do).
Logits and the written pools within 1e-4, greedy tokens identical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu_torch.models import decoder as tdec
from test_torch_families import (NAMES, TOL, assert_close, configs,
                                 family_params, jax_fns, prompts)

torch.set_num_threads(1)

PS, P, NBLK = 8, 24, 8


def pools(cfg, kind, backend):
    shp = (cfg.n_layers, P, cfg.n_kv_heads, PS, cfg.head_dim)
    if backend == "jax":
        if kind == "int8":
            return [{"q": jnp.zeros(shp, jnp.int8),
                     "s": jnp.zeros(shp[:-1], jnp.float32)}
                    for _ in range(2)]
        return [jnp.zeros(shp, jnp.float32) for _ in range(2)]
    if kind == "int8":
        return [{"q": torch.zeros(shp, dtype=torch.int8),
                 "s": torch.zeros(shp[:-1])} for _ in range(2)]
    return [torch.zeros(shp) for _ in range(2)]


def pool_arrays(pool):
    if isinstance(pool, dict):
        return [np.asarray(pool[k]) if not isinstance(pool[k], torch.Tensor)
                else pool[k].numpy() for k in sorted(pool)]
    return [pool.numpy() if isinstance(pool, torch.Tensor)
            else np.asarray(pool)]


@pytest.mark.parametrize("kind", ["int8", "f32"])
@pytest.mark.parametrize("name", NAMES)
def test_paged_extend_and_decode_match_jax(name, kind):
    """Slot 0 admits its 13-token prompt whole; slot 1 admits 16 of its
    30 tokens and extends the other 14 through the paged forward at T =
    14 (a chunked-prefill piece over the pool); then 6 batched decode
    steps, each side on its own greedy tokens."""
    jc, tc = configs(name)
    jp, tp = family_params(name)
    rng = np.random.default_rng(3)
    pr = prompts(rng, tc.vocab_size)
    tables = np.zeros((2, NBLK), np.int32)
    tables[0, :3] = [5, 2, 11]
    tables[1, :6] = [9, 1, 12, 3, 17, 20]
    jk, jv = pools(jc, kind, "jax")
    tk, tv = pools(tc, kind, "torch")
    J = jax_fns(name)
    firsts = []
    for b, n in ((0, 13), (1, 16)):
        toks = np.zeros((1, 16), np.int32)
        toks[0, :n] = pr[b][:n]
        jl, jks, jvs = J["prefill"](jp, tokens=jnp.asarray(toks))
        tl, tks, tvs = tdec.prefill_chunk(tp, tc, torch.tensor(toks).long())
        assert_close(tl, jl)
        jk, jv = J["insert"](jk, jv, jks, jvs, jnp.asarray(tables[b]), n)
        tdec.paged_insert(tc, tk, tv, tks, tvs, torch.tensor(tables[b]), n)
        firsts.append(int(np.argmax(np.asarray(jl)[0, n - 1])))
    # slot 1's second piece: 14 tokens at positions 16..29 over 4 blocks
    tail = pr[1][16:][None]
    jl, jk, jv = J["paged"](
        jp, tokens=jnp.asarray(tail), k_pool=jk, v_pool=jv,
        tables=jnp.asarray(tables[1:]), lengths=jnp.asarray([16], jnp.int32),
        attn_blocks=4)
    tl, tk, tv = tdec.forward_with_cache_paged(
        tp, tc, torch.tensor(tail).long(), tk, tv,
        torch.tensor(tables[1:]), torch.tensor([16], dtype=torch.int32), 4)
    assert_close(tl, jl)
    for t, j in zip(pool_arrays(tk) + pool_arrays(tv),
                    pool_arrays(jk) + pool_arrays(jv)):
        np.testing.assert_allclose(t, j, **TOL)
    firsts[1] = int(np.argmax(np.asarray(jl)[0, -1]))
    lengths = np.array([13, 30], np.int32)
    jtok = ttok = np.array(firsts, np.int32)[:, None]
    for _ in range(6):
        jl, jk, jv = J["paged"](
            jp, tokens=jnp.asarray(jtok), k_pool=jk, v_pool=jv,
            tables=jnp.asarray(tables), lengths=jnp.asarray(lengths),
            attn_blocks=6)
        tl, tk, tv = tdec.forward_with_cache_paged(
            tp, tc, torch.tensor(ttok).long(), tk, tv,
            torch.tensor(tables), torch.tensor(lengths), 6)
        assert_close(tl, jl)
        jtok = np.asarray(jnp.argmax(jl[:, 0], axis=-1)).astype(
            np.int32)[:, None]
        ttok = tl[:, 0].argmax(dim=-1).numpy().astype(np.int32)[:, None]
        np.testing.assert_array_equal(ttok, jtok)
        lengths = lengths + 1
