"""Every preset the port serves against the shape rules of the kernels its
path reaches on the card, on the CPU (a kernel refusal shows only at the
first prefill or decode on the card: gemma's hd 256 at K1 and
starcoder2's group of 12 at the decode kernels did).

For every preset (``check_supported`` accepts them all, mixture of
experts among them), at the engine's default pool on the card
(``resolve_serving_defaults``: int8 pages of its page size; MoE resolves
the dense slot cache): ``flash_prefill``'s head rule where the path prefills through K1
(every arch but the alternating ones, which attend through the einsum),
``paged_shape_error`` for the paged-decode kernels (K4, K5, K6; the
engine checks the same at construction), and the dense-cache decode
limits (K2 for GQA, K3 for MHA). Then the serving dtype and cache kind
each family resolves to on the card.
"""

import dataclasses

import pytest
import torch

from ollama_operator_tpu_torch.models.config import PRESETS
from ollama_operator_tpu_torch.models.decoder import check_supported
from ollama_operator_tpu_torch.ops.attention import (decode_shape_error,
                                                     flash_prefill_shape_error)
from ollama_operator_tpu_torch.ops.paged import paged_shape_error
from ollama_operator_tpu_torch.runtime.engine import (EngineConfig,
                                                      resolve_engine_dtype,
                                                      resolve_paged_default,
                                                      resolve_serving_defaults)


SERVED = sorted(PRESETS)
# the MoE families at their published widths (no preset: qwen3:30b-a3b,
# Qwen1.5-MoE-A2.7B), as chip_smoke.py serves and cross-checks them
MOE_WIDTHS = {
    "qwen3moe": dataclasses.replace(
        PRESETS["mixtral"], vocab_size=151936, dim=2048, n_layers=48,
        n_heads=32, n_kv_heads=4, head_dim=128, ffn_dim=768, n_experts=128,
        n_experts_used=8, qk_norm=True, max_seq_len=40960),
    "qwen2moe": dataclasses.replace(
        PRESETS["mixtral"], vocab_size=151936, dim=2048, n_layers=24,
        n_heads=16, n_kv_heads=16, head_dim=128, ffn_dim=1408, n_experts=60,
        n_experts_used=4, moe_renorm=False, n_shared_ffn=5632,
        attn_bias=True, max_seq_len=8192)}


def test_every_preset_is_supported():
    """``check_supported`` refuses nothing the JAX decoder runs: every
    preset, the mixture-of-experts ones among them, and the MoE families
    at their published widths."""
    assert any(PRESETS[n].n_experts for n in SERVED)
    for cfg in [PRESETS[n] for n in SERVED] + list(MOE_WIDTHS.values()):
        assert check_supported(cfg) is cfg


@pytest.mark.parametrize("name", SERVED)
def test_kernel_shape_rules_take_every_served_preset(name):
    cfg = PRESETS[name]
    H, KvH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ecfg = resolve_serving_defaults(
        EngineConfig(max_slots=0, paged=None, page_size=0,
                     max_seq_len=4096), cfg, "cuda")
    # mixture of experts serves on the dense slot cache, as the JAX
    # package serves it; every other preset pages
    assert ecfg.paged == (not cfg.n_experts)
    if not cfg.altern_sliding:
        assert flash_prefill_shape_error(H, KvH, hd) is None
    assert paged_shape_error(H, KvH, hd, ecfg.page_size, False) is None
    assert paged_shape_error(H, KvH, hd, ecfg.page_size, True) is None
    assert decode_shape_error(H, KvH, hd) is None


@pytest.mark.parametrize("name", sorted(MOE_WIDTHS))
def test_moe_widths_take_their_kernels_on_the_dense_cache(name):
    """qwen3moe (32/4 heads: K1, K2 at G 8) and qwen2moe (16/16: K1, K3)
    at their published widths: the dense slot cache of 8 slots, bf16
    weights on the card, and K1's and the decode kernels' head rules."""
    cfg = MOE_WIDTHS[name].validate()
    H, KvH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    ecfg = resolve_serving_defaults(
        EngineConfig(max_slots=0, paged=None, page_size=0, decode_chunk=0,
                     max_seq_len=4096), cfg, "cuda")
    assert (ecfg.paged, ecfg.max_slots, ecfg.decode_chunk) == (False, 8, 32)
    assert resolve_engine_dtype(cfg, "cuda") == "bfloat16"
    assert flash_prefill_shape_error(H, KvH, hd) is None
    assert decode_shape_error(H, KvH, hd) is None
    assert (H // KvH) == (8 if name == "qwen3moe" else 1)


def test_moe_parameter_counts():
    """The sizes the one-card MoE path rests on (``ModelConfig.n_params``,
    which counts the routed experts and the router, not qwen2moe's shared
    expert): qwen3:30b-a3b 30.53e9 (61.06 GB in bf16), Qwen1.5-MoE-A2.7B's
    routed part 13.49e9; mixtral 46.70e9, over one card's 80 GB in bf16."""
    assert round(MOE_WIDTHS["qwen3moe"].n_params / 1e7) == 3053
    assert round(MOE_WIDTHS["qwen2moe"].n_params / 1e7) == 1349
    assert round(PRESETS["mixtral"].n_params / 1e7) == 4670


def test_refusals_name_the_limit():
    assert "hd=264" in flash_prefill_shape_error(16, 16, 264)
    assert "hd=136" in flash_prefill_shape_error(16, 16, 136)
    assert "at most 16" in decode_shape_error(34, 2, 128)
    assert "at most 8" in decode_shape_error(18, 2, 72)
    assert "at most 16" in paged_shape_error(34, 2, 128, 128, False)


@pytest.mark.parametrize("name,dtype", [
    ("gemma3", "int8"), ("starcoder2", "int8"), ("phi", "int8"),
    ("qwen3", "int4"), ("gemma2", "int4"), ("gemma", "int4"),
    ("gemma2:27b", "int4")])
def test_engine_dtype_per_family(name, dtype):
    """int8 weights below 4e9 parameters, int4 at or above, on the card
    (gemma3 3.88e9, starcoder2 3.03e9, phi 2.78e9; qwen3 8.19e9, gemma2
    9.24e9, gemma 8.54e9); f32 on the CPU."""
    cfg = PRESETS[name]
    assert resolve_engine_dtype(cfg, "cuda") == dtype
    assert resolve_engine_dtype(cfg, "cpu") == "float32"


@pytest.mark.parametrize("name", ["qwen3", "gemma2", "gemma3",
                                  "starcoder2", "phi", "gemma"])
def test_paged_defaults_per_family(name, monkeypatch):
    """Every dense family pages on the card: GQA at 64 slots of 128-row
    pages, MHA (phi, gemma) at 32 slots of 64-row pages; an MHA model
    stays dense when the v3 kernel is reverted; nothing pages on the
    CPU."""
    cfg = PRESETS[name]
    monkeypatch.delenv("TPU_PAGED_V3", raising=False)
    assert resolve_paged_default(cfg, "cuda") is True
    assert resolve_paged_default(cfg, "cpu") is False
    ecfg = resolve_serving_defaults(
        EngineConfig(max_slots=0, paged=None, page_size=0,
                     max_seq_len=4096), cfg, "cuda")
    gqa = cfg.n_kv_heads < cfg.n_heads
    assert (ecfg.max_slots, ecfg.page_size) == ((64, 128) if gqa
                                                 else (32, 64))
    monkeypatch.setenv("TPU_PAGED_V3", "0")
    assert resolve_paged_default(cfg, "cuda") is gqa


def test_gemma3_global_rope_is_linear_scaled():
    """gemma3's full layers rotate at theta 1e6 with its linear factor 8
    (``scaled_inv_freq``), its sliding layers at the unscaled local 10k
    table."""
    from ollama_operator_tpu_torch.models.decoder import (_layer_rope,
                                                          _rope_pair)
    cfg = dataclasses.replace(PRESETS["gemma3"], n_layers=6)
    pos = torch.arange(5)[None]
    rope = _rope_pair(pos, cfg)
    half = cfg.rotary_dim // 2
    base = 1e6 ** (-torch.arange(half, dtype=torch.float64) / half)
    local = 1e4 ** (-torch.arange(half, dtype=torch.float64) / half)
    for i in range(cfg.n_layers):
        cos, _ = _layer_rope(cfg, i, rope)
        inv = base / 8.0 if i == 5 else local
        want = torch.cos(pos[..., None].double() * inv).float()
        torch.testing.assert_close(cos, want, rtol=0, atol=1e-5)
