"""The port's mixture-of-experts path against the JAX package's, on the CPU.

Three tiny configs, as the JAX package's MoE families set their flags:

- ``tiny-moe`` (mixtral: top-2 of 4, the softmax over the selected
  logits);
- a qwen2moe (top-2 of 6 with the full softmax's gates kept as they are,
  a shared expert and its sigmoid gate, attention biases, MHA);
- a qwen3moe (top-3 of 8 renormalised, qk-norm, rope theta 1e6).

``_moe_gates`` and ``_moe_mlp`` of both packages on the same f32 inputs,
in both forms (``moe_impl`` "einsum" and "scan"), within rtol = atol =
2e-4 (JAX ``tests/test_moe.py``'s tolerance) with identical selected
experts; the port's scan, which computes an expert for its routed tokens
only, bit-equal to every expert over every token; ``_moe_mlp`` in bf16
against the JAX function the serving path calls, within one bf16 ulp of
the largest output; the dense-cache engine's greedy streams (prefill,
decode, a prompt admitted in pieces, a repeat over a parked prefix)
against the JAX ``Engine`` and ``Scheduler``; int8 and int4 weights,
which quantize the attention projections only; the FLOP accounting.
"""

import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops import quant as jquant
from ollama_operator_tpu.runtime import accounting as jacc
from ollama_operator_tpu.runtime.engine import Engine as JEngine
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import SlotOptions as JSlotOptions
from ollama_operator_tpu.runtime.scheduler import Scheduler as JScheduler
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.models.config import resolve_moe_impl
from ollama_operator_tpu_torch.ops import quant as tquant
from ollama_operator_tpu_torch.runtime import accounting as tacc
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)
from test_torch_rounding import bf16_pair

torch.set_num_threads(1)

TOL = dict(rtol=2e-4, atol=2e-4)
MOE = {
    "mixtral": {},
    "qwen2moe": dict(n_experts=6, n_experts_used=2, moe_renorm=False,
                     n_shared_ffn=96, attn_bias=True, n_kv_heads=4),
    "qwen3moe": dict(n_experts=8, n_experts_used=3, qk_norm=True,
                     rope_theta=1e6),
}
NAMES = sorted(MOE)


def configs(name: str, **kw):
    """(the JAX config with its kernels in interpret mode, the port's)."""
    kw = {**MOE[name], **kw}
    return (dataclasses.replace(JPRESETS["tiny-moe"], kernels="interpret",
                                **kw).validate(),
            dataclasses.replace(TPRESETS["tiny-moe"], **kw).validate())


@functools.lru_cache(maxsize=None)
def moe_params(name: str):
    """(JAX params, the port's params) of the config, f32, with random
    biases (qwen2moe), so that every leaf moves the output."""
    jc, _ = configs(name)
    init = jax.jit(jdec.init_params, static_argnums=(0, 2))
    p = jax.tree_util.tree_map(np.asarray, init(
        jc, jax.random.key(NAMES.index(name) + 5), jnp.float32))
    rng = np.random.default_rng(31)
    for k in ("bq", "bk", "bv"):
        if k in p["layers"]:
            p["layers"][k] = rng.normal(0.0, 0.2, p["layers"][k].shape
                                        ).astype(np.float32)
    return (jax.tree_util.tree_map(jnp.asarray, p),
            params_from_numpy(p, device="cpu"))


def layer0(name: str, scale: float = 1.0):
    """Layer 0's leaves of the config's params (JAX, torch), the expert
    matrices scaled by ``scale`` so that an expert's output is not lost
    beside its input."""
    jp, tp = moe_params(name)

    def leaf(k, v):
        return v[0] * (scale if k.startswith("we_") else 1.0)
    return ({k: leaf(k, v) for k, v in jp["layers"].items()},
            {k: leaf(k, v) for k, v in tp["layers"].items()})


# the JAX functions under test, jitted (one compile a config and shape;
# eager JAX compiles op by op)
jax_gates = jax.jit(jdec._moe_gates, static_argnums=0)
jax_mlp = jax.jit(jdec._moe_mlp, static_argnums=0)


def tokens(rng, shape, dim):
    x = rng.standard_normal((*shape, dim)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("name", NAMES)
def test_moe_gates_match_jax(name):
    jc, tc = configs(name)
    jl, tl = layer0(name, scale=30.0)
    jx, tx = tokens(np.random.default_rng(1), (40,), tc.dim)
    want = np.asarray(jax_gates(jc, jl, jx))
    got = tdec._moe_gates(tc, tl, tx)
    assert got.dtype == torch.float32 and got.shape == (40, tc.n_experts)
    got = got.numpy()
    np.testing.assert_array_equal(got != 0, want != 0)
    assert ((got != 0).sum(-1) == tc.n_experts_used).all()
    np.testing.assert_allclose(got, want, **TOL)
    if tc.moe_renorm:
        np.testing.assert_allclose(got.sum(-1), 1.0, rtol=1e-6)
    else:
        assert (got.sum(-1) < 1.0).all()


@pytest.mark.parametrize("impl", ["einsum", "scan"])
@pytest.mark.parametrize("name", NAMES)
def test_moe_mlp_matches_jax(name, impl):
    jc, tc = configs(name, moe_impl=impl)
    jl, tl = layer0(name, scale=30.0)
    jx, tx = tokens(np.random.default_rng(2), (2, 7), tc.dim)
    got = tdec._moe_mlp(tc, tl, tx)
    assert got.dtype == torch.float32 and got.shape == tx.shape
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jax_mlp(jc, jl, jx)), **TOL)


def test_auto_takes_the_scan_above_256_tokens():
    """"auto" switches at 256 tokens, as the JAX package's does: 260
    tokens through both packages' scan; 256 through the einsum."""
    jc, tc = configs("qwen3moe")
    jl, tl = layer0("qwen3moe", scale=30.0)
    rng = np.random.default_rng(3)
    for n, form in ((260, "scan"), (256, "einsum")):
        jx, tx = tokens(rng, (1, n), tc.dim)
        got = tdec._moe_mlp(tc, tl, tx).numpy()
        np.testing.assert_allclose(got, np.asarray(jax_mlp(jc, jl, jx)),
                                   **TOL)
        forced = dataclasses.replace(tc, moe_impl=form)
        np.testing.assert_array_equal(got, tdec._moe_mlp(forced, tl,
                                                         tx).numpy())


@pytest.mark.parametrize("name", NAMES)
def test_scan_of_routed_tokens_is_the_dense_scan_bit_for_bit(name):
    """The port's scan runs an expert for the tokens routed to it only; in
    f32 that is every expert over every token, each output weighted by its
    gate (0 where unselected) and added in expert order, bit for bit."""
    _, tc = configs(name, moe_impl="scan")
    _, tl = layer0(name, scale=30.0)
    _, tx = tokens(np.random.default_rng(4), (3, 50), tc.dim)
    xf = tx.reshape(-1, tc.dim)
    gates = tdec._moe_gates(tc, tl, xf)
    acc = torch.zeros_like(xf)
    for e in range(tc.n_experts):
        he = tdec._act(tc, xf @ tl["we_gate"][e]) * (xf @ tl["we_up"][e])
        acc = acc + gates[:, e, None] * (he @ tl["we_down"][e])
    if "we_sh_gate" in tl:
        hs = tdec._act(tc, xf @ tl["we_sh_gate"]) * (xf @ tl["we_sh_up"])
        acc = acc + torch.sigmoid(xf @ tl["sh_gate"]) * (
            hs @ tl["we_sh_down"])
    got = tdec._moe_mlp(tc, tl, tx).reshape(-1, tc.dim)
    assert torch.equal(got, acc)


@pytest.mark.parametrize("name", NAMES)
def test_moe_mlp_rounds_like_jax_in_bf16(name):
    """bf16 weights and activations: the port's ``_moe_mlp`` against the
    JAX function the serving path calls ("auto": the einsum at decode and
    piece sizes), every output within one bf16 ulp of the largest, and
    the same experts selected."""
    jc, tc = configs(name)
    rng = np.random.default_rng(5)
    pairs = {k: bf16_pair(v.numpy()) for k, v in layer0(name, 30.0)[1].items()}
    jl = {k: j for k, (j, _) in pairs.items()}
    tl = {k: t for k, (_, t) in pairs.items()}
    jx, tx = bf16_pair(rng.standard_normal((2, 9, tc.dim)))
    t = tdec._moe_mlp(tc, tl, tx)
    assert t.dtype == torch.bfloat16
    j = np.asarray(jax_mlp(jc, jl, jx).astype(jnp.float32))
    np.testing.assert_allclose(t.float().numpy(), j, rtol=0,
                               atol=2 ** -7 * np.abs(j).max())
    jg = np.asarray(jax_gates(jc, jl, jx.reshape(-1, tc.dim)))
    tg = tdec._moe_gates(tc, tl, tx.reshape(-1, tc.dim)).numpy()
    np.testing.assert_array_equal(tg != 0, jg != 0)


def test_init_params_makes_the_jax_leaves():
    for name in NAMES:
        jc, tc = configs(name)
        jp = jax.eval_shape(lambda: jdec.init_params(
            jc, jax.random.key(0), jnp.float32))
        tp = tdec.init_params(tc, torch.Generator().manual_seed(0),
                              torch.float32, device="cpu")
        shapes = {k: tuple(v.shape) for k, v in jp["layers"].items()}
        assert {k: tuple(v.shape) for k, v in tp["layers"].items()} == shapes
        assert "w_up" not in shapes and "w_gate" not in shapes
        assert shapes["we_down"] == (tc.n_layers, tc.n_experts,
                                     tc.ffn_dim, tc.dim)
        assert ("sh_gate" in shapes) == bool(tc.n_shared_ffn)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_weights_leave_the_experts_dense(bits):
    """int8 / int4 serving quantizes the attention projections (and the
    LM head) only, as the JAX package's ``QUANT_LAYER_KEYS``: the router
    and expert stacks stay dense, and the prefill logits agree."""
    jc, tc = configs("qwen3moe")
    jp = jax.tree_util.tree_map(np.asarray, moe_params("qwen3moe")[0])
    jq = jquant.quantize_params(jax.tree_util.tree_map(jnp.asarray, jp),
                                bits=bits)
    tq = params_from_numpy(jax.tree_util.tree_map(np.asarray, jq),
                           device="cpu")
    again = tquant.quantize_params(params_from_numpy(jp, device="cpu"),
                                   bits=bits)
    for k, v in again["layers"].items():
        assert tquant.is_quantized(v) == jquant.is_quantized(jq["layers"][k])
        assert tquant.is_quantized(v) == (k in ("wq", "wk", "wv", "wo")), k
    toks = np.random.default_rng(6).integers(1, tc.vocab_size, (1, 16))
    want, _, _ = jdec.prefill_chunk(jq, dataclasses.replace(
        jc, kernels="xla"), jnp.asarray(toks, jnp.int32))
    got, _, _ = tdec.prefill_chunk(tq, tc, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_flops_and_params_follow_the_jax_formulas():
    for name in NAMES:
        jc, tc = configs(name)
        assert tacc.per_token_flops(tc) == jacc.per_token_flops(jc)
        assert tc.n_params == jc.n_params
        assert tacc.prefill_flops(tc, 3, 40) == jacc.prefill_flops(jc, 3, 40)
    _, q2 = configs("qwen2moe")
    dense = dataclasses.replace(q2, n_shared_ffn=0)
    assert (tacc.per_token_flops(q2) - tacc.per_token_flops(dense)
            == q2.n_layers * 6 * q2.dim * q2.n_shared_ffn)


COMMON = dict(max_slots=4, max_seq_len=128, min_prefill_bucket=16,
              paged=False, decode_chunk=4)


def run(sched, opts, vocab):
    """A 40-token prompt (three pieces of 16) beside two short ones, then
    a prompt that shares the long one's first 36 tokens (over its parked
    slot). Returns (the four streams, the last request's reused tokens)."""
    rng = np.random.default_rng(21)
    long_ = [int(x) for x in rng.integers(1, vocab, 40)]
    short = [[int(x) for x in rng.integers(1, vocab, n)] for n in (6, 11)]
    reqs = [sched.submit(p, opts, max_tokens=n)
            for p, n in ((long_, 8), (short[0], 12), (short[1], 12))]
    streams = [[] for _ in reqs]

    def read(i, req):
        for chunk in req.chunks():
            streams[i].extend(chunk)

    ts = [threading.Thread(target=read, args=(i, r))
          for i, r in enumerate(reqs)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts)
    parked = long_[:36] + [int(x) for x in rng.integers(1, vocab, 5)]
    req = sched.submit(parked, opts, max_tokens=8)
    streams.append(list(req.tokens()))
    return streams, req.stats.n_reused


@pytest.mark.parametrize("name", ["qwen2moe", "qwen3moe"])
def test_dense_cache_streams_match_jax_engine(name):
    from ollama_operator_tpu_torch.runtime.scheduler import Scheduler
    jc, tc = configs(name)
    jp, tp = moe_params(name)
    je = JEngine(jc, jp, ecfg=JEngineConfig(cache_dtype=jnp.float32,
                                            **COMMON))
    jsched = JScheduler(je, prefill_chunk=16)
    try:
        want, j_reused = run(jsched, JSlotOptions(temperature=0.0),
                             tc.vocab_size)
    finally:
        jsched.shutdown()
    te = Engine(tc, tp, EngineConfig(cache_dtype=torch.float32, **COMMON),
                device="cpu")
    assert te.cfg.moe_impl == je.cfg.moe_impl == resolve_moe_impl(tc)
    sched = Scheduler(te, prefill_chunk=16)
    try:
        got, reused = run(sched, SlotOptions(temperature=0.0),
                          tc.vocab_size)
        assert sched.n_prefill_pieces >= 3
    finally:
        sched.shutdown()
    assert [len(s) for s in got] == [8, 12, 12, 8]
    assert got == want
    assert reused == j_reused and reused > 0
