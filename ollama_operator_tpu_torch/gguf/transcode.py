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
the other's cache. Vision towers, encoders and LoRA adapters are not
ported; ``server/app.py`` refuses models that need them.
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

# the JAX package's encoder (embedding-only) arches, refused by the port
ENCODER_ARCHES = ("bert",)


def is_encoder_arch(arch: str) -> bool:
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
    if cfg.n_experts:
        raise NotImplementedError(
            "mixture-of-experts tensors are not mapped by the torch port")
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
    else:
        layers["w_up"] = stack("blk.{}.ffn_up.weight", T_)
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
    if cfg.mlp_type == "gated" and not fused_gate_up:
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
