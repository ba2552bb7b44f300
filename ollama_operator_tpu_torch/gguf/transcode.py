"""GGUF checkpoint → ModelConfig + decoder params (numpy, the port's layout).

The parts of ``ollama_operator_tpu/gguf/transcode.py`` that text models
need, giving the same config and the same bits:

1. **Config mapping**: '<arch>.*' metadata keys → models.config.ModelConfig
   (``config_from_gguf``, a copy, rope scaling included).
2. **Tensor mapping**: llama.cpp tensor names (token_embd, blk.N.attn_q, …)
   → the decoder's param tree, layer tensors stacked on a leading axis,
   weights transposed to [in, out] (``load_params``).
3. **RoPE convention fix**: arches that llama.cpp runs with *interleaved*
   rope (llama/mistral family) have their q/k projection rows un-permuted
   to the half-split layout the decoder's rope uses.

The tree's leaves are float32 arrays, or for bfloat16 uint16 arrays of the
bf16 bit patterns: the cast runs through torch's bfloat16, which rounds to
nearest even as the JAX package's ``ml_dtypes`` cast does, so the bits
agree. ``convert.params_from_numpy`` carries the tree to the card.

Transcoded output is cached through gguf/store.py, keyed by (content
digest, dtype) exactly as the JAX package keys it, so either package reads
the other's cache. BERT-family encoders (embedding models) map through
``encoder_config_from_gguf`` and ``load_encoder_params`` to
``models/encoder.py``, and a llava mmproj GGUF (arch "clip") through
``vision_config_from_gguf`` and ``load_vision_params`` to
``models/vision.py``, both uncached, as in the JAX package. LoRA adapters
merge into a loaded tree in ``gguf/lora.py``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.config import ModelConfig
from . import dequant as DQ
from .reader import GGUFFile
from .store import TensorStore, TensorStoreWriter

# arches whose GGUF q/k weights are stored in the interleaved-rope (Meta)
# layout and need un-permuting for half-split rope (mistral/mixtral GGUFs
# carry arch "llama")
_INTERLEAVED_ROPE_ARCHES = {"llama", "granite", "command-r"}

# embedding-only arches: served by models/encoder.py without an Engine
ENCODER_ARCHES = ("bert",)


def is_encoder_arch(arch: str) -> bool:
    """True for embedding-only architectures, which load as
    ``runtime/service.EmbeddingModel`` (no Engine, no KV cache)."""
    return arch in ENCODER_ARCHES


def dtype_name(dtype) -> str:
    """"bfloat16" or "float32" for a dtype given by name, as a torch dtype
    or as numpy's float32; the cache key's suffix, as numpy names the
    dtype in the JAX package."""
    if dtype in ("bfloat16", torch.bfloat16):
        return "bfloat16"
    if dtype in ("float32", torch.float32) or (
            not isinstance(dtype, (str, torch.dtype))
            and np.dtype(dtype) == np.float32):
        return "float32"
    raise ValueError(f"transcode dtype {dtype!r}; expected bfloat16 or "
                     f"float32")


def bf16_bits(a: np.ndarray) -> np.ndarray:
    """float32 array → uint16 array of its bf16 bit patterns (round to
    nearest even), C-contiguous."""
    t = torch.from_numpy(np.asarray(a, np.float32))
    t = t.to(torch.bfloat16, memory_format=torch.contiguous_format)
    return t.view(torch.int16).numpy().view(np.uint16)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------

def _rope_scaling_from_gguf(f: GGUFFile) -> Dict[str, Any]:
    """rope.scaling.* metadata + the rope_freqs factor tensor → ModelConfig
    rope fields (= llama.cpp's semantics).

    llama3.1-family conversions pre-bake their low/high-freq scheme into a
    ``rope_freqs.weight`` tensor of per-frequency divisors; when present it
    takes precedence (it applies INSTEAD of the metadata scheme, matching
    llama.cpp). Legacy keys ``rope.scale_linear`` / ``rope.scale`` (old
    GGUF exports) map onto the linear scheme.
    """
    out: Dict[str, Any] = {}
    stype = f.field("rope.scaling.type")
    factor = f.field("rope.scaling.factor")
    if factor is None:
        factor = f.field("rope.scale_linear", f.field("rope.scale"))
        if factor is not None and stype is None:
            stype = "linear"
    if stype is not None and str(stype) not in ("none", "linear", "yarn",
                                                "longrope"):
        raise NotImplementedError(
            f"unsupported GGUF rope.scaling.type {stype!r}")
    if stype is not None and str(stype) not in ("none", "longrope"):
        # longrope is carried entirely by the rope_factors_* tensors
        # (handled below) — the metadata type itself maps to no scheme
        out["rope_scaling_type"] = str(stype)
    if factor is not None and float(factor) > 0:
        out["rope_scaling"] = float(factor)
    octx = f.field("rope.scaling.original_context_length")
    if octx:
        out["rope_orig_ctx"] = int(octx)
    attn_f = f.field("rope.scaling.attn_factor")
    if attn_f:
        out["rope_attn_factor"] = float(attn_f)
    bf = f.field("rope.scaling.yarn_beta_fast")
    if bf:
        out["rope_yarn_beta_fast"] = float(bf)
    bs = f.field("rope.scaling.yarn_beta_slow")
    if bs:
        out["rope_yarn_beta_slow"] = float(bs)
    if "rope_freqs.weight" in f.tensors:
        ff = DQ.dequantize_tensor(f, f.tensors["rope_freqs.weight"])
        out["rope_freq_factors"] = tuple(
            float(x) for x in np.asarray(ff, np.float64).reshape(-1))
    elif "rope_factors_long.weight" in f.tensors:
        # phi3-family longrope: two per-frequency divisor tensors; the
        # GGUF's full declared window selects which applies (long when it
        # exceeds the original training window), and cos/sin scale by the
        # longrope magnitude factor sqrt(1 + ln(ctx/orig)/ln(orig)) unless
        # the conversion recorded an explicit attn_factor
        ctx = int(f.field("context_length", 4096))
        octx2 = int(octx or ctx)
        name = ("rope_factors_long.weight" if ctx > octx2
                else "rope_factors_short.weight")
        ff = DQ.dequantize_tensor(f, f.tensors[name])
        out["rope_freq_factors"] = tuple(
            float(x) for x in np.asarray(ff, np.float64).reshape(-1))
        if not out.get("rope_attn_factor") and ctx > octx2:
            out["rope_attn_factor"] = float(
                np.sqrt(1.0 + np.log(ctx / octx2) / np.log(octx2)))
    elif str(stype or "") == "longrope":
        raise ValueError(
            "rope.scaling.type is longrope but the GGUF carries no "
            "rope_factors_long/short tensors — refusing to serve with "
            "unscaled rope (outputs past the original window would be "
            "garbage)")
    # yarn needs the original window; older exports omit it — fall back to
    # context_length / factor (the convention llama.cpp applies)
    if (out.get("rope_scaling_type") == "yarn"
            and not out.get("rope_orig_ctx")):
        ctx = int(f.field("context_length", 4096))
        out["rope_orig_ctx"] = max(1, int(ctx / out.get("rope_scaling",
                                                        1.0)))
    return out


def config_from_gguf(f: GGUFFile) -> ModelConfig:
    """The JAX package's ``config_from_gguf``: every arch it maps is mapped
    the same way here, including those the port's decoder does not run
    yet (``decoder.check_supported`` refuses them at load)."""
    arch = f.arch
    n_heads = int(f.field("attention.head_count"))
    dim = int(f.field("embedding_length"))
    head_dim = int(f.field("attention.key_length", dim // n_heads))
    kv = f.field("attention.head_count_kv", n_heads)
    if isinstance(kv, list):
        kv = kv[0]
    base = dict(
        gguf_arch=arch,   # raw source arch, kept for rope-layout decisions
        vocab_size=len(f.metadata["tokenizer.ggml.tokens"]),
        dim=dim,
        n_layers=int(f.field("block_count")),
        n_heads=n_heads,
        n_kv_heads=int(kv),
        head_dim=head_dim,
        ffn_dim=int(f.field("feed_forward_length")),
        max_seq_len=int(f.field("context_length", 4096)),
        rope_theta=float(f.field("rope.freq_base", 10000.0)),
        sliding_window=int(f.field("attention.sliding_window", 0) or 0),
    )
    base.update(_rope_scaling_from_gguf(f))
    eps = f.field("attention.layer_norm_rms_epsilon")
    if eps is not None:
        base["norm_eps"] = float(eps)
    n_exp = int(f.field("expert_count", 0) or 0)
    if n_exp:  # mixtral family (GGUF arch is still "llama")
        base["n_experts"] = n_exp
        base["n_experts_used"] = int(f.field("expert_used_count", 2))

    if arch in ("llama", "mistral"):
        cfg = ModelConfig(arch="llama", **base)
    elif arch == "qwen2":
        cfg = ModelConfig(arch="llama", attn_bias=True, **base)
    elif arch == "qwen3":
        # qwen2 minus the qkv bias, plus per-head RMS on q/k
        cfg = ModelConfig(arch="llama", qk_norm=True, **base)
    elif arch == "qwen2moe":
        # qwen2-style attention (qkv bias) + sparse MoE with a shared
        # sigmoid-gated expert and un-renormalised top-k router gates
        if not base.get("n_experts"):
            raise ValueError("qwen2moe GGUF without expert_count metadata")
        if f.field("expert_used_count") is None:
            raise ValueError(
                "qwen2moe GGUF without expert_used_count metadata")
        shared = int(f.field("expert_shared_feed_forward_length", 0) or 0)
        cfg = ModelConfig(arch="llama", attn_bias=True, moe_renorm=False,
                          n_shared_ffn=shared, **base)
    elif arch == "qwen3moe":
        # qwen3 attention (qk norms, no bias) + sparse MoE MLPs; the
        # generic top-2 default would silently misroute, so the count is
        # required
        if not base.get("n_experts"):
            raise ValueError("qwen3moe GGUF without expert_count metadata")
        if f.field("expert_used_count") is None:
            raise ValueError(
                "qwen3moe GGUF without expert_used_count metadata")
        cfg = ModelConfig(arch="llama", qk_norm=True, **base)
    elif arch == "gemma":
        cfg = ModelConfig(arch="llama", act="gelu_tanh", emb_scale=True,
                          tie_embeddings=True, norm_weight_offset=1.0, **base)
    elif arch == "gemma2":
        if not base.get("sliding_window"):
            # alternation is part of the arch; a gguf without the window
            # metadata must fail loudly, not silently serve full attention
            raise ValueError(
                "gemma2 GGUF lacks attention.sliding_window metadata")
        # llama.cpp writes no query_pre_attn_scalar key: 27B (the only
        # 46-layer gemma2) scales by 1/sqrt(n_embd/n_head), 2B/9B by
        # 1/sqrt(head_dim)
        qpas = float(f.field("attention.query_pre_attn_scalar", 0) or 0)
        if not qpas and base["n_layers"] == 46:
            qpas = base["dim"] / base["n_heads"]
        cfg = ModelConfig(
            arch="llama", act="gelu_tanh", emb_scale=True,
            tie_embeddings=True, norm_weight_offset=1.0, post_norms=True,
            altern_sliding=True,
            attn_softcap=float(f.field("attn_logit_softcapping", 50.0)),
            logit_softcap=float(f.field("final_logit_softcapping", 30.0)),
            attn_scale=qpas,
            **base)
    elif arch == "command-r":
        # parallel attn+mlp block sharing one bias-free LayerNorm, tied
        # embeddings, logits multiplied by logit_scale (the field divides:
        # store the reciprocal), interleaved-rope weight storage
        base["norm_eps"] = float(f.field("attention.layer_norm_epsilon",
                                         1e-5))
        v = f.field("logit_scale")
        if not v:
            raise ValueError("command-r GGUF without logit_scale metadata")
        if "blk.0.attn_q_norm.weight" in f.tensors:
            raise NotImplementedError(
                "command-r variants with q/k norms are not supported yet")
        cfg = ModelConfig(arch="llama", norm_type="layernorm",
                          norm_bias=False, parallel_block=True,
                          tie_embeddings=True,
                          logit_scale=1.0 / float(v), **base)
    elif arch == "granite":
        # llama block + four scalar multipliers the conversion records as
        # granite.*.scale keys; q/k stored llama-permuted
        extra = {}
        for key, fld in (("attention.scale", "attn_scale_mult"),
                         ("embedding.scale", "emb_multiplier"),
                         ("residual.scale", "residual_multiplier"),
                         ("logit_scale", "logit_scale")):
            v = f.field(key)
            if v:
                extra[fld] = float(v)
        cfg = ModelConfig(arch="llama", **extra, **base)
    elif arch == "gemma3":
        if not base.get("sliding_window"):
            raise ValueError(
                "gemma3 GGUF lacks attention.sliding_window metadata")
        # pattern-6 alternation, qk RMS norms, dual rope (local 10k theta);
        # query_pre_attn_scalar: 256, but dim/n_heads for the 62-layer 27B
        qpas = float(f.field("attention.query_pre_attn_scalar", 0) or 0)
        if not qpas:
            qpas = (base["dim"] / base["n_heads"]
                    if base["n_layers"] == 62 else 256.0)
        cfg = ModelConfig(
            arch="llama", act="gelu_tanh", emb_scale=True,
            tie_embeddings=True, norm_weight_offset=1.0, post_norms=True,
            altern_sliding=True, sliding_pattern=6, qk_norm=True,
            rope_local_theta=10000.0, attn_scale=qpas,
            **base)
    elif arch == "phi3":
        # llama-family block converted with fused attn_qkv and gate+up
        # ffn_up tensors (split in load_params) and longrope
        if not base.get("sliding_window") and base["max_seq_len"] <= 4096:
            # older conversions of the 4k tags omit the window key
            # (llama.cpp hardcodes phi3's n_swa for the same reason)
            base["sliding_window"] = 2047
        cfg = ModelConfig(arch="llama", **base)
    elif arch == "phi2":
        base["norm_eps"] = float(f.field("attention.layer_norm_epsilon",
                                         1e-5))
        rot = int(f.field("rope.dimension_count", head_dim))
        cfg = ModelConfig(arch="phi2", norm_type="layernorm",
                          mlp_type="plain", act="gelu_tanh",
                          parallel_block=True, attn_bias=True, out_bias=True,
                          rotary_pct=rot / head_dim, **base)
    elif arch == "starcoder2":
        # sequential pre-LN block, LayerNorm + biases everywhere, plain
        # gelu-tanh MLP, full NEOX rotary, sliding-window attention
        base["norm_eps"] = float(f.field("attention.layer_norm_epsilon",
                                         1e-5))
        cfg = ModelConfig(arch="llama", norm_type="layernorm",
                          mlp_type="plain", act="gelu_tanh",
                          attn_bias=True, out_bias=True, **base)
    else:
        raise NotImplementedError(f"unsupported GGUF architecture {arch!r}")
    if not cfg.tie_embeddings and "output.weight" not in f.tensors:
        # any arch may tie the head to the embedding (llama3.2, small
        # qwen2): llama.cpp falls back to token_embd when the output
        # tensor is absent
        cfg = dataclasses.replace(cfg, tie_embeddings=True)
    return cfg.validate()


# ---------------------------------------------------------------------------
# tensors
# ---------------------------------------------------------------------------

def _unpermute_rope(w: np.ndarray, n_heads: int) -> np.ndarray:
    """[out, in] q/k weight: interleaved-pair rows → half-split rows."""
    out, inn = w.shape
    hd = out // n_heads
    return (w.reshape(n_heads, hd // 2, 2, inn)
             .transpose(0, 2, 1, 3)
             .reshape(out, inn))


def _unpermute_rope_vec(b: np.ndarray, n_heads: int) -> np.ndarray:
    out = b.shape[0]
    hd = out // n_heads
    return (b.reshape(n_heads, hd // 2, 2)
             .transpose(0, 2, 1)
             .reshape(out))


def _dq(f: GGUFFile, name: str) -> np.ndarray:
    return DQ.dequantize_tensor(f, f.tensors[name])


def _expert_leaves(f: GGUFFile, cfg: ModelConfig, stack, cast
                   ) -> Dict[str, Any]:
    """The mixture-of-experts leaves, as the JAX transcode maps them: the
    router ``ffn_gate_inp`` [E, D] → [D, E]; merged ``ffn_{gate,up}_exps``
    [E, F, D] → [E, D, F] and ``ffn_down_exps`` [E, D, F] → [E, F, D] (a
    transpose per expert, to the dense path's [in, out]), or the legacy
    split ``ffn_{gate,up,down}.{e}`` tensors of pre-merge GGUFs stacked
    the same way; qwen2moe's shared expert ``ffn_*_shexp`` and its gate
    ``ffn_gate_inp_shexp``. A GGUF without them raises ``KeyError``
    naming the first missing tensor."""
    L, E = cfg.n_layers, cfg.n_experts
    eT = lambda a: a.transpose(0, 2, 1)  # noqa: E731
    T_ = lambda a: a.T  # noqa: E731
    out = {"router": stack("blk.{}.ffn_gate_inp.weight", T_)}
    for key, part in (("we_gate", "gate"), ("we_up", "up"),
                      ("we_down", "down")):
        merged = f"blk.{{}}.ffn_{part}_exps.weight"
        split = f"blk.{{}}.ffn_{part}.{{}}.weight"
        if merged.format(0) in f.tensors:
            out[key] = stack(merged, eT)
        elif split.format(0, 0) in f.tensors:
            out[key] = np.stack([np.stack([cast(_dq(f, split.format(i, e)).T)
                                           for e in range(E)])
                                 for i in range(L)])
        else:
            raise KeyError(f"missing tensor {merged.format(0)} (or the "
                           f"split {split.format(0, 0)}) of a {E}-expert "
                           f"model")
    if "blk.0.ffn_gate_shexp.weight" in f.tensors:
        for key, name in (("we_sh_gate", "ffn_gate_shexp"),
                          ("we_sh_up", "ffn_up_shexp"),
                          ("we_sh_down", "ffn_down_shexp"),
                          ("sh_gate", "ffn_gate_inp_shexp")):
            out[key] = stack(f"blk.{{}}.{name}.weight", T_)
    return out


def load_params(f: GGUFFile, cfg: Optional[ModelConfig] = None,
                dtype="bfloat16") -> Dict[str, Any]:
    """Dequantise + remap every tensor into the decoder param tree (numpy,
    host memory): float32 leaves, or uint16 bf16 patterns for
    ``dtype="bfloat16"``. One tensor is dequantized to float32 at a time;
    the layer leaves are stacked in the target dtype."""
    cfg = cfg or config_from_gguf(f)
    unpermute = f.arch in _INTERLEAVED_ROPE_ARCHES
    L = cfg.n_layers
    if dtype_name(dtype) == "bfloat16":
        cast = bf16_bits
    else:
        def cast(a):
            return np.ascontiguousarray(a, dtype=np.float32)

    params: Dict[str, Any] = {
        "tok_emb": cast(_dq(f, "token_embd.weight")),
        "out_norm_w": cast(_dq(f, "output_norm.weight")),
    }
    if cfg.norm_type == "layernorm" and cfg.norm_bias:
        params["out_norm_b"] = cast(_dq(f, "output_norm.bias"))
    if not cfg.tie_embeddings:
        params["lm_head"] = cast(_dq(f, "output.weight").T)
    if cfg.out_bias and "output.bias" in f.tensors:
        params["lm_head_b"] = cast(_dq(f, "output.bias"))

    def stack(fmt: str, post=None, required=True):
        name0 = fmt.format(0)
        if name0 not in f.tensors:
            if required:
                raise KeyError(f"missing tensor {name0}")
            return None
        arrs = []
        for i in range(L):
            a = _dq(f, fmt.format(i))
            if post is not None:
                a = post(a)
            arrs.append(cast(a))
        return np.stack(arrs)

    H, KvH = cfg.n_heads, cfg.n_kv_heads
    unp_q = (lambda a: _unpermute_rope(a, H).T) if unpermute else (lambda a: a.T)
    unp_k = (lambda a: _unpermute_rope(a, KvH).T) if unpermute else (lambda a: a.T)
    T_ = lambda a: a.T  # noqa: E731

    layers: Dict[str, Any] = {
        "attn_norm_w": stack("blk.{}.attn_norm.weight"),
        "wo": stack("blk.{}.attn_output.weight", T_),
    }
    fused_gate_up = (cfg.mlp_type == "gated" and not cfg.n_experts
                     and "blk.0.ffn_gate.weight" not in f.tensors)
    if fused_gate_up:
        # phi3-family: ffn_up holds [gate; up] fused ([2F, D]); split so
        # the decoder's separate projections serve unchanged
        F = cfg.ffn_dim
        gs, us = [], []
        for i in range(L):
            w = _dq(f, f"blk.{i}.ffn_up.weight")
            assert w.shape[0] == 2 * F, (
                f"fused ffn_up rows {w.shape[0]} != 2*ffn_dim {2 * F}")
            gs.append(cast(w[:F].T))
            us.append(cast(w[F:].T))
        layers["w_gate"] = np.stack(gs)
        layers["w_up"] = np.stack(us)
    elif not cfg.n_experts:
        layers["w_up"] = stack("blk.{}.ffn_up.weight", T_)
    if not cfg.n_experts:
        layers["w_down"] = stack("blk.{}.ffn_down.weight", T_)
    if "blk.0.attn_qkv.weight" in f.tensors:  # fused qkv (phi2, phi3)
        q_dim, kv_dim = cfg.q_dim, cfg.kv_dim
        wq, wk, wv, bq, bk, bv = [], [], [], [], [], []
        for i in range(L):
            w = _dq(f, f"blk.{i}.attn_qkv.weight")  # [q+2kv, D]
            wq.append(cast(w[:q_dim].T))
            wk.append(cast(w[q_dim:q_dim + kv_dim].T))
            wv.append(cast(w[q_dim + kv_dim:].T))
            if f"blk.{i}.attn_qkv.bias" in f.tensors:
                b = _dq(f, f"blk.{i}.attn_qkv.bias")
                bq.append(cast(b[:q_dim]))
                bk.append(cast(b[q_dim:q_dim + kv_dim]))
                bv.append(cast(b[q_dim + kv_dim:]))
        layers["wq"], layers["wk"], layers["wv"] = map(np.stack, (wq, wk, wv))
        if bq:
            layers["bq"], layers["bk"], layers["bv"] = map(
                np.stack, (bq, bk, bv))
    else:
        layers["wq"] = stack("blk.{}.attn_q.weight", unp_q)
        layers["wk"] = stack("blk.{}.attn_k.weight", unp_k)
        layers["wv"] = stack("blk.{}.attn_v.weight", T_)
        if cfg.attn_bias:
            unp_bq = ((lambda a: _unpermute_rope_vec(a, H))
                      if unpermute else None)
            unp_bk = ((lambda a: _unpermute_rope_vec(a, KvH))
                      if unpermute else None)
            layers["bq"] = stack("blk.{}.attn_q.bias", unp_bq)
            layers["bk"] = stack("blk.{}.attn_k.bias", unp_bk)
            layers["bv"] = stack("blk.{}.attn_v.bias")

    if cfg.norm_type == "layernorm" and cfg.norm_bias:
        layers["attn_norm_b"] = stack("blk.{}.attn_norm.bias")
    if not cfg.parallel_block:
        layers["mlp_norm_w"] = stack("blk.{}.ffn_norm.weight")
        if cfg.norm_type == "layernorm" and cfg.norm_bias:
            layers["mlp_norm_b"] = stack("blk.{}.ffn_norm.bias")
    if cfg.n_experts:
        layers.update(_expert_leaves(f, cfg, stack, cast))
    elif cfg.mlp_type == "gated" and not fused_gate_up:
        layers["w_gate"] = stack("blk.{}.ffn_gate.weight", T_)
    if cfg.out_bias:
        layers["bo"] = stack("blk.{}.attn_output.bias")
        layers["b_up"] = stack("blk.{}.ffn_up.bias")
        layers["b_down"] = stack("blk.{}.ffn_down.bias")
    if cfg.post_norms:
        layers["post_attn_norm_w"] = (
            stack("blk.{}.post_attention_norm.weight")
            if "blk.0.post_attention_norm.weight" in f.tensors
            else stack("blk.{}.attn_post_norm.weight"))
        layers["post_ffw_norm_w"] = (
            stack("blk.{}.post_ffw_norm.weight")
            if "blk.0.post_ffw_norm.weight" in f.tensors
            else stack("blk.{}.ffn_post_norm.weight"))
    if cfg.qk_norm:
        layers["q_norm_w"] = stack("blk.{}.attn_q_norm.weight")
        layers["k_norm_w"] = stack("blk.{}.attn_k_norm.weight")

    params["layers"] = {k: v for k, v in layers.items() if v is not None}
    return params


# ---------------------------------------------------------------------------
# encoders (bert)
# ---------------------------------------------------------------------------

def encoder_config_from_gguf(f: GGUFFile):
    """'<arch>.*' metadata → models.encoder.EncoderConfig (bert family).
    ``pooling_type`` 1 is mean pooling and 2 the [CLS] row; any other
    raises, as in the JAX package (a wrong pooling gives silently wrong
    embeddings)."""
    from ..models.encoder import EncoderConfig
    pooling = int(f.field("pooling_type", 1) or 1)
    if pooling not in (1, 2):
        raise NotImplementedError(
            f"unsupported bert pooling_type {pooling} (mean=1 and cls=2 "
            f"are implemented)")
    return EncoderConfig(
        vocab_size=len(f.metadata["tokenizer.ggml.tokens"]),
        dim=int(f.field("embedding_length")),
        n_layers=int(f.field("block_count")),
        n_heads=int(f.field("attention.head_count")),
        ffn_dim=int(f.field("feed_forward_length")),
        max_seq_len=int(f.field("context_length", 512)),
        norm_eps=float(f.field("attention.layer_norm_epsilon", 1e-12)),
        pooling={1: "mean", 2: "cls"}[pooling],
        arch=f.arch)


def load_encoder_params(f: GGUFFile, cfg=None,
                        dtype=np.float32) -> Dict[str, Any]:
    """llama.cpp's BERT tensor names (attn_output_norm the post-attention
    LayerNorm, layer_output_norm the post-FFN one) → the models.encoder
    param tree of numpy arrays, weights transposed to [in, out] and layer
    leaves stacked on a leading axis."""
    cfg = cfg or encoder_config_from_gguf(f)

    def cast(a):
        return np.ascontiguousarray(a, dtype=dtype)

    def stack(fmt: str, transpose: bool = False):
        return np.stack([cast(_dq(f, fmt.format(i)).T if transpose
                              else _dq(f, fmt.format(i)))
                         for i in range(cfg.n_layers)])

    layers = {}
    for leaf, name in (("q", "attn_q"), ("k", "attn_k"), ("v", "attn_v"),
                       ("o", "attn_output")):
        layers[f"w{leaf}"] = stack(f"blk.{{}}.{name}.weight", True)
        layers[f"b{leaf}"] = stack(f"blk.{{}}.{name}.bias")
    layers.update(
        attn_norm_w=stack("blk.{}.attn_output_norm.weight"),
        attn_norm_b=stack("blk.{}.attn_output_norm.bias"),
        w_up=stack("blk.{}.ffn_up.weight", True),
        b_up=stack("blk.{}.ffn_up.bias"),
        w_down=stack("blk.{}.ffn_down.weight", True),
        b_down=stack("blk.{}.ffn_down.bias"),
        ffn_norm_w=stack("blk.{}.layer_output_norm.weight"),
        ffn_norm_b=stack("blk.{}.layer_output_norm.bias"))
    return {"tok_emb": cast(_dq(f, "token_embd.weight")),
            "pos_emb": cast(_dq(f, "position_embd.weight")),
            "type_emb": cast(_dq(f, "token_types.weight")),
            "emb_norm_w": cast(_dq(f, "token_embd_norm.weight")),
            "emb_norm_b": cast(_dq(f, "token_embd_norm.bias")),
            "layers": layers}


# ---------------------------------------------------------------------------
# vision tower (llava mmproj GGUF, arch "clip")
# ---------------------------------------------------------------------------

def vision_config_from_gguf(f: GGUFFile):
    """clip-arch mmproj metadata → models.vision.VisionConfig. The
    projector's output width comes from the mm.2 tensor (the LLM's
    embedding width)."""
    from ..models.vision import VisionConfig

    def g(k, d=None):
        return f.metadata.get("clip.vision." + k, d)
    mm2 = f.tensors.get("mm.2.weight")
    proj_dim = int(mm2.shape[0]) if mm2 is not None else int(
        f.metadata.get("clip.vision.projection_dim", 4096))
    return VisionConfig(
        image_size=int(g("image_size", 336)),
        patch_size=int(g("patch_size", 14)),
        width=int(g("embedding_length", 1024)),
        n_layers=int(g("block_count", 24)),
        n_heads=int(g("attention.head_count", 16)),
        ffn_dim=int(g("feed_forward_length", 4096)),
        norm_eps=float(g("attention.layer_norm_epsilon", 1e-5)),
        proj_dim=proj_dim,
        # llama.cpp's llava converter drops the skipped last CLIP layer
        # before export (block_count already counts the penultimate
        # selection), so a GGUF-loaded tower runs every file layer
        select_layer=-1,
    ).validate()


def load_vision_params(f: GGUFFile, vcfg=None,
                       dtype="float32") -> Dict[str, Any]:
    """mmproj tensors → the models.vision param tree of numpy arrays
    (float32, or uint16 bf16 patterns for ``dtype="bfloat16"``).

    llama.cpp's clip names (v.patch_embd, v.blk.N.*, mm.0 / mm.2); the two
    ffn tensors are mapped by shape, not by name, because mmproj exports
    disagree on which of ffn_up / ffn_down is the W→F projection."""
    vcfg = vcfg or vision_config_from_gguf(f)
    L, W, Fd = vcfg.n_layers, vcfg.width, vcfg.ffn_dim
    if dtype_name(dtype) == "bfloat16":
        cast = bf16_bits
    else:
        def cast(a):
            return np.ascontiguousarray(a, dtype=np.float32)

    pe = _dq(f, "v.patch_embd.weight")              # [W, 3, P, P]
    params: Dict[str, Any] = {
        "patch_emb": cast(pe.reshape(W, -1).T),      # [3*P*P, W], (c,i,j)
        "class_emb": cast(_dq(f, "v.class_embd")),
        "pos_emb": cast(_dq(f, "v.position_embd.weight")),
        "pre_ln_w": cast(_dq(f, "v.pre_ln.weight")),
        "pre_ln_b": cast(_dq(f, "v.pre_ln.bias")),
        "mm_0": cast(_dq(f, "mm.0.weight").T),
        "mm_0_b": cast(_dq(f, "mm.0.bias")),
        "mm_2": cast(_dq(f, "mm.2.weight").T),
        "mm_2_b": cast(_dq(f, "mm.2.bias")),
    }

    def stack(fmt: str, transpose: bool = False):
        return np.stack([cast(_dq(f, fmt.format(i)).T if transpose
                              else _dq(f, fmt.format(i)))
                         for i in range(L)])

    layers = {"ln1_w": stack("v.blk.{}.ln1.weight"),
              "ln1_b": stack("v.blk.{}.ln1.bias"),
              "ln2_w": stack("v.blk.{}.ln2.weight"),
              "ln2_b": stack("v.blk.{}.ln2.bias")}
    for leaf, name in (("q", "attn_q"), ("k", "attn_k"), ("v", "attn_v"),
                       ("o", "attn_out")):
        layers[f"w{leaf}"] = stack(f"v.blk.{{}}.{name}.weight", True)
        layers[f"b{leaf}"] = stack(f"v.blk.{{}}.{name}.bias")
    # the ffn tensor stored [out, in] = [F, W] is the W→F one (w_up)
    up, down = (("ffn_up", "ffn_down")
                if tuple(f.tensors["v.blk.0.ffn_up.weight"].shape) == (Fd, W)
                else ("ffn_down", "ffn_up"))
    layers.update(w_up=stack(f"v.blk.{{}}.{up}.weight", True),
                  b_up=stack(f"v.blk.{{}}.{up}.bias"),
                  w_down=stack(f"v.blk.{{}}.{down}.weight", True),
                  b_down=stack(f"v.blk.{{}}.{down}.bias"))
    params["layers"] = layers
    return params


# ---------------------------------------------------------------------------
# cached transcode
# ---------------------------------------------------------------------------

def _flatten(params: Dict[str, Any]):
    for k, v in params.items():
        if k == "layers":
            for lk, lv in v.items():
                yield f"layers/{lk}", lv
        else:
            yield k, v


def _unflatten(items) -> Dict[str, Any]:
    out: Dict[str, Any] = {"layers": {}}
    for k, v in items:
        if k.startswith("layers/"):
            out["layers"][k.split("/", 1)[1]] = v
        else:
            out[k] = v
    return out


def _tokenizer_metadata(f: GGUFFile) -> dict:
    return {k: v for k, v in f.metadata.items() if k.startswith("tokenizer.")}


def transcode_to_store(gguf_path: str, store_path: str,
                       dtype="bfloat16") -> Tuple[ModelConfig, dict]:
    """GGUF → TensorStore on disk. Returns (cfg, tokenizer metadata)."""
    with GGUFFile(gguf_path) as f:
        cfg = config_from_gguf(f)
        params = load_params(f, cfg, dtype)
        tok_md = _tokenizer_metadata(f)
        w = TensorStoreWriter(store_path)
        w.add_meta("config", cfg.__dict__)
        w.add_meta("tokenizer", tok_md)
        w.add_meta("source", os.path.basename(gguf_path))
        for name, arr in _flatten(params):
            w.add(name, arr)
        w.finish()
    return cfg, tok_md


def load_from_store(store_path: str) -> Tuple[ModelConfig, Dict[str, Any], dict]:
    """mmap-load a cached transcode. Returns (cfg, params, tokenizer md)."""
    ts = TensorStore(store_path)
    cfg = ModelConfig(**ts.meta["config"]).validate()
    params = _unflatten(ts.items())
    return cfg, params, ts.meta["tokenizer"]


def content_fingerprint(path: str) -> str:
    """Cheap content digest for cache keying: sha256 over (size, head 1MiB,
    tail 1MiB). Registry-pulled blobs are already content-addressed by
    their layer digest, which callers should prefer via ``digest=``."""
    h = hashlib.sha256()
    size = os.path.getsize(path)
    h.update(str(size).encode())
    with open(path, "rb") as f:
        h.update(f.read(1 << 20))
        if size > (1 << 20):
            f.seek(max(size - (1 << 20), 0))
            h.update(f.read(1 << 20))
    return h.hexdigest()[:24]


def cache_path(cache_dir: str, digest: str, dtype) -> str:
    """Where ``load_model`` caches a transcode: ``<digest>.<dtype>``."""
    return os.path.join(cache_dir, f"{digest}.{dtype_name(dtype)}")


def load_model(gguf_path: str, cache_dir: Optional[str] = None,
               dtype="bfloat16", digest: Optional[str] = None):
    """The serving entry point: transcode once, mmap afterwards.
    Returns (cfg, numpy params, tokenizer metadata).

    ``digest``: content digest of the GGUF (e.g. the registry layer sha256);
    computed from the file when omitted. Keys the cache so a replaced model
    file at the same path never serves stale weights.
    """
    if cache_dir is None:
        with GGUFFile(gguf_path) as f:
            cfg = config_from_gguf(f)
            params = load_params(f, cfg, dtype)
            tok_md = _tokenizer_metadata(f)
        return cfg, params, tok_md
    if digest is None:
        digest = content_fingerprint(gguf_path)
    store_path = cache_path(cache_dir, digest, dtype)
    if not TensorStore.exists(store_path):
        transcode_to_store(gguf_path, store_path, dtype)
    return load_from_store(store_path)
