"""The torch port's numerics against the JAX package's, on the CPU.

Inputs come from numpy generators and go to both sides; the port runs in
f32 on the CPU. Tolerances: codes of the int4/int8 quantizers must be
bit-identical (both round half to even in f32), scales and elementwise
ops (rope, rms_norm, penalties) agree to 1e-6 (f32 rounding of the same
formulas in two frameworks).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops import norms as jnorms
from ollama_operator_tpu.ops import quant as jquant
from ollama_operator_tpu.ops import quant_cache as jqc
from ollama_operator_tpu.ops import rope as jrope
from ollama_operator_tpu.ops import sampling as jsampling
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.ops import norms as tnorms
from ollama_operator_tpu_torch.ops import quant as tquant
from ollama_operator_tpu_torch.ops import quant_cache as tqc
from ollama_operator_tpu_torch.ops import rope as trope
from ollama_operator_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)


def test_config_copy_matches_reference():
    assert set(JPRESETS) == set(TPRESETS)
    for name in JPRESETS:
        assert (dataclasses.asdict(JPRESETS[name])
                == dataclasses.asdict(TPRESETS[name])), name


@pytest.mark.parametrize("name", ["llama3.1", "tiny", "gemma3", "qwen2"])
def test_rope_scaled_inv_freq_and_rotation(name):
    cfg = JPRESETS[name]
    jargs = dict(scaling_type=cfg.rope_scaling_type, factor=cfg.rope_scaling,
                 orig_ctx=cfg.rope_orig_ctx,
                 low_freq_factor=cfg.rope_low_freq_factor,
                 high_freq_factor=cfg.rope_high_freq_factor)
    assert (jrope.scaled_inv_freq(cfg.rotary_dim, cfg.rope_theta, **jargs)
            == trope.scaled_inv_freq(cfg.rotary_dim, cfg.rope_theta,
                                     **jargs))
    rng = np.random.default_rng(1)
    B, T, H = 2, 9, 3
    pos = rng.integers(0, 100000, (B, T)).astype(np.int32)
    x = rng.standard_normal((B, T, H, cfg.head_dim)).astype(np.float32)
    jc, js = jrope.rope_angles_cfg(jnp.asarray(pos), cfg)
    tc, ts = trope.rope_angles_cfg(torch.from_numpy(pos), TPRESETS[name])
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)
    jo = jrope.apply_rope(jnp.asarray(x), jc, js, cfg.rotary_dim)
    to = trope.apply_rope(torch.from_numpy(x), torch.tensor(np.array(jc)),
                          torch.tensor(np.array(js)), cfg.rotary_dim)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6)


@pytest.mark.parametrize("offset", [0.0, 1.0])
def test_rms_norm(offset):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3, 5, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    j = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5, offset)
    t = tnorms.rms_norm(torch.from_numpy(x), torch.from_numpy(w), 1e-5,
                        offset)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-6)


def test_apply_penalties():
    rng = np.random.default_rng(3)
    B, V = 4, 50
    logits = rng.standard_normal((B, V)).astype(np.float32) * 3
    counts = rng.integers(0, 3, (B, V)).astype(np.int32)
    vals = dict(repeat_penalty=[1.1, 1.0, 1.3, 0.9],
                presence_penalty=[0.0, 0.5, 0.2, 0.0],
                frequency_penalty=[0.0, 0.1, 0.0, 0.3])
    jsp = jsampling.SamplingParams.make(B)
    jsp = dataclasses.replace(jsp, **{k: jnp.asarray(v, jnp.float32)
                                      for k, v in vals.items()})
    rows = [dict(temperature=0.0, top_k=40, top_p=0.9, min_p=0.0,
                 typical_p=1.0, **{k: v[b] for k, v in vals.items()})
            for b in range(B)]
    tsp = tsampling.SamplingParams.from_rows(rows, "cpu")
    j = jsampling.apply_penalties(jnp.asarray(logits), jnp.asarray(counts),
                                  jsp)
    t = tsampling.apply_penalties(torch.from_numpy(logits),
                                  torch.from_numpy(counts), tsp)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                               atol=1e-6)
    assert (tsampling.sample(torch.from_numpy(logits),
                             torch.from_numpy(counts), tsp).numpy()
            == np.asarray(jnp.argmax(j, axis=-1))).all()


@pytest.mark.parametrize("shape", [(64, 32), (2, 128, 96)])
def test_int4_codes_bit_identical(shape):
    rng = np.random.default_rng(4)
    w = rng.standard_normal(shape).astype(np.float32) * 0.05
    w[..., :32, 0] = 0.0                     # an all-zero group: scale 0
    j = jquant.quantize_groupwise_int4(w)
    t = tquant.quantize_groupwise_int4(torch.from_numpy(w))
    assert t["q4"].dtype == torch.uint8
    np.testing.assert_array_equal(t["q4"].numpy(), np.asarray(j["q4"]))
    np.testing.assert_allclose(t["s"].numpy(), np.asarray(j["s"]),
                               rtol=0, atol=1e-7)
    np.testing.assert_array_equal(
        tquant.unpack_int4(t["q4"]).numpy(),
        np.asarray(jquant.unpack_int4(np.asarray(j["q4"]))))
    j8 = jquant.quantize_groupwise(w)
    t8 = tquant.quantize_groupwise(torch.from_numpy(w))
    np.testing.assert_array_equal(t8["q"].numpy(), np.asarray(j8["q"]))
    np.testing.assert_allclose(t8["s"].numpy(), np.asarray(j8["s"]),
                               rtol=0, atol=1e-7)


def test_quantize_kv_codes_bit_identical():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 3, 7, 64)).astype(np.float32)
    x[0, 0, 0] = 0.0
    jq, js = jqc.quantize_kv(jnp.asarray(x))
    tq, ts = tqc.quantize_kv(torch.from_numpy(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-7)


def test_tied_int8_tree_converts_bit_for_bit():
    """A tied-embedding tree (no ``lm_head``) with int8 {"q", "s"} leaves
    and a bf16 ``tok_emb`` crosses ``params_from_numpy`` bit for bit."""
    import jax

    from ollama_operator_tpu.models import decoder as jdec
    from ollama_operator_tpu_torch.convert import params_from_numpy
    cfg = dataclasses.replace(JPRESETS["tiny"], tie_embeddings=True)
    pn = jquant.quantize_params(jax.tree_util.tree_map(
        np.asarray, jdec.init_params(cfg, jax.random.key(2), jnp.float32)),
        bits=8)
    pn["tok_emb"] = np.asarray(jnp.asarray(pn["tok_emb"], jnp.bfloat16))
    tp = params_from_numpy(pn, device="cpu")
    assert "lm_head" not in tp and set(tp["layers"]["w_down"]) == {"q", "s"}
    assert tp["tok_emb"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["tok_emb"].view(torch.int16).numpy(),
        pn["tok_emb"].view(np.int16))
    for k, v in pn["layers"].items():
        for kk, a in (v.items() if isinstance(v, dict) else [("", v)]):
            t = tp["layers"][k][kk] if kk else tp["layers"][k]
            assert t.dtype == getattr(torch, a.dtype.name), (k, kk)
            np.testing.assert_array_equal(t.numpy(), a)
