"""The port's kernel modules against the JAX package's Pallas kernels.

The JAX side runs each Pallas kernel in interpret mode on the CPU, as the
JAX package's own tests do; the port runs the plain PyTorch version that
stands beside each CUDA kernel (the wrapper picks it because the tensors
are on the CPU; the CUDA kernels themselves are checked against the same
plain versions on the card by ``chip_smoke.py``). Everything is f32 unless
a test says otherwise.
Tolerances: 1e-4 abs/rel for attention (f32 softmax sums reassociated
across blocks; 1e-5 for the int4 pool at G = 3), 2e-5 for the int8 and
int4 matmuls (f32 dot of the same dequantized weights, summed in another
order). With bf16 activations the matmuls are held to 1e-5 x max|y|: the
kernels and their plain versions round the dequantized weight to bf16 as
the Pallas kernels do (the int8 matmul at N <= 16 takes the XLA ``qmm``'s
decode form instead, the function that serves int8 weights there), so
only the f32 summation order differs.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.ops import quant as jquant
from ollama_operator_tpu.ops.pallas.flash import flash_prefill as jflash
from ollama_operator_tpu.ops.pallas.paged import paged_decode_attention_v3
from ollama_operator_tpu.ops.pallas.quant import qmm4_pallas, qmm_pallas
from ollama_operator_tpu_torch.ops import attention as tattn
from ollama_operator_tpu_torch.ops import cuda_build
from ollama_operator_tpu_torch.ops import paged as tpaged
from ollama_operator_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)


def _t(a):
    return torch.tensor(np.array(a))


@pytest.mark.parametrize("H,KvH,window,softcap", [
    (8, 8, 0, 0.0), (8, 2, 0, 0.0), (4, 1, 0, 0.0), (8, 2, 32, 30.0)])
def test_flash_prefill_matches_pallas(H, KvH, window, softcap):
    rng = np.random.default_rng(10 + H + KvH + window)
    B, T, hd = 2, 128, 64
    q = rng.standard_normal((B, T, H, hd)).astype(np.float32)
    k = rng.standard_normal((B, KvH, T, hd)).astype(np.float32)
    v = rng.standard_normal((B, KvH, T, hd)).astype(np.float32)
    scale = hd ** -0.5
    j = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), scale,
               softcap, window, interpret=True)
    t = tattn.flash_prefill(_t(q), _t(k), _t(v), scale, softcap, window)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                               atol=1e-4)


def _paged_inputs(rng, quant):
    B, H, KvH, hd, ps, L, P, NBLK = 4, 8, 2, 64, 16, 2, 24, 5
    lengths = np.array([1, ps - 1, ps, 3 * ps + 5], np.int32)
    tables = np.zeros((B, NBLK), np.int32)
    pages = rng.permutation(np.arange(1, P))
    for b in range(B):
        n = lengths[b] // ps + 1
        tables[b, :n] = pages[:n]
        pages = pages[n:]
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)
    if quant:
        def pool():
            return {"q": rng.integers(-127, 128, (L, P, KvH, ps, hd)
                                      ).astype(np.int8),
                    "s": rng.uniform(0.001, 0.02, (L, P, KvH, ps)
                                     ).astype(np.float32)}
    else:
        def pool():
            return rng.standard_normal((L, P, KvH, ps, hd)
                                       ).astype(np.float32)
    return q, pool(), pool(), tables, lengths


def _conv(pool, f):
    return {k: f(v) for k, v in pool.items()} if isinstance(pool, dict) \
        else f(pool)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("window", [0, 24])
def test_paged_decode_matches_pallas_v3(quant, window):
    rng = np.random.default_rng(20 + quant + window)
    q, kp, vp, tables, lengths = _paged_inputs(rng, quant)
    nblk, scale = tables.shape[1], 64 ** -0.5
    for layer in (0, 1):
        j = paged_decode_attention_v3(
            jnp.asarray(q), _conv(kp, jnp.asarray), _conv(vp, jnp.asarray),
            jnp.int32(layer), jnp.asarray(tables), jnp.asarray(lengths),
            scale, 0.0, window, nblk=nblk, interpret=True)
        t = tpaged.paged_decode_attention(
            _t(q), _conv(kp, _t), _conv(vp, _t), layer, _t(tables),
            _t(lengths), scale, 0.0, window, nblk=nblk)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("N,K,O", [(1, 64, 128), (8, 256, 256),
                                   (5, 128, 384), (70, 256, 128)])
def test_qmm4_matches_pallas(N, K, O):
    rng = np.random.default_rng(30 + N)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((K, O)).astype(np.float32) * 0.05
    qw = jquant.quantize_groupwise_int4(w)
    j = qmm4_pallas(jnp.asarray(x), jnp.asarray(qw["q4"]),
                    jnp.asarray(qw["s"]), interpret=True)
    t = tquant.qmm4(_t(x), _t(qw["q4"]), _t(qw["s"]))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=2e-5,
                               atol=2e-5)


def _bf16_pair(a):
    """A float array → the same bf16 values as a JAX and a torch array."""
    t = torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


@pytest.mark.parametrize("N,K,O", [(1, 256, 128), (8, 256, 384),
                                   (64, 512, 256)])
def test_qmm_matches_pallas(N, K, O):
    """int8 weights: f32 x within 2e-5 relative against ``qmm_pallas``;
    bf16 x within 1e-5 x max|y| against the function that serves int8
    weights in the JAX package: ``qmm_pallas`` (the dequantized weight
    rounded to bf16) at N = 64, where the XLA ``qmm`` computes the same,
    and the XLA ``qmm``'s decode form (the scale after each group's exact
    dot) at N <= 16, fed x as f32 holding the same bf16 values."""
    rng = np.random.default_rng(40 + N)
    x = rng.standard_normal((N, K)).astype(np.float32)
    w = rng.standard_normal((K, O)).astype(np.float32) * 0.02
    qw = jquant.quantize_groupwise(w)
    jq, js = jnp.asarray(qw["q"]), jnp.asarray(qw["s"])
    j = np.asarray(qmm_pallas(jnp.asarray(x), jq, js, interpret=True))
    t = tquant.qmm(_t(x), _t(qw["q"]), _t(qw["s"]))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=2e-5,
                               atol=2e-5 * np.abs(j).max())
    jx, tx = _bf16_pair(x)
    if N <= 16:
        j = np.asarray(jquant.qmm(jx.astype(jnp.float32), {"q": jq, "s": js},
                                  out_dtype=jnp.float32))
    else:
        j = np.asarray(qmm_pallas(jx, jq, js, interpret=True))
    t = tquant.qmm(tx, _t(qw["q"]), _t(qw["s"]))
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


def test_qmm4_bf16_rounds_weight_like_pallas():
    """With bf16 x, ``qmm4_pallas`` rounds code x scale to bf16 before
    its f32-accumulated dot; ``qmm4_plain`` (and the CUDA kernel) must
    compute the same function (an f32 weight differs by ~2e-3 here)."""
    rng = np.random.default_rng(50)
    x = rng.standard_normal((8, 256)).astype(np.float32)
    w = rng.standard_normal((256, 256)).astype(np.float32) * 0.02
    qw = jquant.quantize_groupwise_int4(w)
    jx, tx = _bf16_pair(x)
    j = np.asarray(qmm4_pallas(jx, jnp.asarray(qw["q4"]),
                               jnp.asarray(qw["s"]), interpret=True))
    t = tquant.qmm4_plain(tx, _t(qw["q4"]), _t(qw["s"]))
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


def _paged_int4_inputs(rng):
    B, H, KvH, hd, ps, L, P, NBLK = 4, 6, 2, 64, 16, 2, 24, 5
    lengths = np.array([1, ps - 1, ps, 3 * ps + 5], np.int32)
    tables = np.zeros((B, NBLK), np.int32)
    pages = rng.permutation(np.arange(1, P))
    for b in range(B):
        n = lengths[b] // ps + 1
        tables[b, :n] = pages[:n]
        pages = pages[n:]
    q = rng.standard_normal((B, 1, H, hd)).astype(np.float32)

    def pool():
        return {"q4": rng.integers(0, 256, (L, P, KvH, ps // 2, hd)
                                   ).astype(np.uint8),
                "s": rng.uniform(0.01, 0.2, (L, P, KvH, ps)
                                 ).astype(np.float32)}
    return q, pool(), pool(), tables, lengths


@pytest.mark.parametrize("window", [0, 32])
def test_paged_decode_int4_pool_matches_pallas_v3(window):
    """An int4 {"q4", "s"} pool at G = 3: the plain path (gather +
    unpack) against ``paged_decode_attention_v3`` in interpret mode,
    within 1e-5. The JAX pool holds the same bytes as int8."""
    rng = np.random.default_rng(60 + window)
    q, kp, vp, tables, lengths = _paged_int4_inputs(rng)
    nblk, scale = tables.shape[1], 64 ** -0.5

    def jpool(p):
        return {"q4": jnp.asarray(p["q4"].view(np.int8)),
                "s": jnp.asarray(p["s"])}
    for layer in (0, 1):
        j = paged_decode_attention_v3(
            jnp.asarray(q), jpool(kp), jpool(vp), jnp.int32(layer),
            jnp.asarray(tables), jnp.asarray(lengths), scale, 0.0, window,
            nblk=nblk, interpret=True)
        t = tpaged.paged_decode_attention(
            _t(q), _conv(kp, _t), _conv(vp, _t), layer, _t(tables),
            _t(lengths), scale, 0.0, window, nblk=nblk)
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5,
                                   atol=1e-5)


# llama3.2:3b's and phi3's int8 projection shapes (K, O): wq/wo, wk/wv,
# w_gate/w_up, w_down, phi3's qkv (O = 3 x 3072) and untied LM head
# (O = 32064, a ragged last column tile), and a second ragged O
QMM_SHAPES = [(3072, 3072), (3072, 1024), (3072, 8192), (8192, 3072),
              (3072, 9216), (3072, 32064), (3072, 8192 + 64)]


@pytest.mark.parametrize("N", [1, 8, 16, 17, 64, 512])
def test_qmm_mma_plan_covers_every_group_and_row(N):
    """The tensor-core qmm kernel's plan: one 16-row tile (the decode form)
    exactly at N <= 16, else 2, 4 or 8 tiles; its row blocks cover N (the
    last one is needed), its K splits cover every group once, in split
    order, with no empty split, within one wave of one CTA a SM; every
    shape is one the kernel takes."""
    for K, O in QMM_SHAPES:
        mt, row_blocks, ksplit, gps = tquant.qmm_mma_plan(N, K, O)
        assert mt == (1 if N <= 16 else 2 if N <= 32 else 4 if N <= 64
                      else 8)
        assert (mt == 1) == (N <= tquant.DECODE_N)
        assert (row_blocks - 1) * 16 * mt < N <= row_blocks * 16 * mt
        G = K // 32
        assert ksplit >= 1 and (ksplit - 1) * gps < G <= ksplit * gps
        starts = [z * gps for z in range(ksplit)]
        covered = [g for z in starts for g in range(z, min(z + gps, G))]
        assert covered == list(range(G))
        if ksplit > 1:
            assert gps >= 8
            assert -(-O // 256) * row_blocks * ksplit <= 132
        assert K % 32 == 0 and O % 16 == 0


@pytest.mark.parametrize("O", [8200, 32068, 1028])
def test_qmm_kernel_refuses_columns_off_its_copies(O, monkeypatch):
    """On the card the qmm wrapper takes O % 16 == 0 (the kernel copies
    code rows in 16-byte chunks) and raises on anything else, O % 4 == 0
    included, before it builds or launches anything."""
    monkeypatch.setattr(cuda_build, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_build, "function", None)
    K = 64
    x = torch.zeros((8, K), dtype=torch.bfloat16)
    q = torch.zeros((K, O), dtype=torch.int8)
    s = torch.zeros((K // 32, O), dtype=torch.float32)
    with pytest.raises(ValueError, match="unsupported"):
        tquant.qmm(x, q, s)


@pytest.mark.parametrize("N", [1, 8, 17, 64, 512])
def test_qmm4_mma_plan_covers_every_group_and_row(N):
    """The tensor-core qmm4 kernel's plan at llama3.1's projection
    shapes: its 16-row tiles cover N (the last row block is needed), its
    K splits cover every group once, in split order, with no empty
    split."""
    for K, O in [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                 (4096, 128256), (96, 16)]:
        mt, row_blocks, ksplit, gps = tquant.qmm4_mma_plan(N, K, O)
        assert mt in (1, 2, 4) and mt == (1 if N <= 16 else
                                          2 if N <= 32 else 4)
        assert (row_blocks - 1) * 16 * mt < N <= row_blocks * 16 * mt
        G = K // 32
        assert ksplit >= 1 and (ksplit - 1) * gps < G <= ksplit * gps
        starts = [z * gps for z in range(ksplit)]
        covered = [g for z in starts for g in range(z, min(z + gps, G))]
        assert covered == list(range(G))
        if ksplit > 1:
            assert gps >= 8
            assert -(-O // 256) * row_blocks * ksplit <= 264


@pytest.mark.parametrize("hd", [8, 24, 40, 136])
def test_flash_prefill_kernel_refuses_head_dims(hd, monkeypatch):
    """On the card the flash-prefill wrapper takes hd a multiple of 16 up
    to 128 (the TPU kernel's rule) and raises on anything else before it
    builds or launches anything."""
    monkeypatch.setattr(cuda_build, "on_card", lambda *t: True)
    monkeypatch.setattr(cuda_build, "function", None)
    q = torch.zeros((1, 8, 4, hd), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 8, hd), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="unsupported"):
        tattn.flash_prefill(q, k, k, hd ** -0.5)


def test_wrappers_refuse_mixed_devices():
    """A wrapper never hands a kernel a tensor it cannot read: inputs on
    a device other than the CPU or one CUDA card raise instead of taking
    the plain path."""
    x = torch.zeros((2, 64))
    w = tquant.quantize_groupwise_int4(torch.zeros((64, 128)))
    with pytest.raises(ValueError, match="one CUDA device"):
        tquant.qmm4(x.to("meta"), w["q4"], w["s"])
    q = torch.zeros((1, 8, 2, 16))
    with pytest.raises(ValueError, match="one CUDA device"):
        tattn.flash_prefill(q, torch.zeros((1, 2, 8, 16), device="meta"),
                            torch.zeros((1, 2, 8, 16)), 0.25)
