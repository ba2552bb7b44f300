"""Model architecture configs for the decoder family.

A copy of ``ollama_operator_tpu/models/config.py`` (the torch port keeps
its own copy and imports nothing of the JAX package). The architecture is a
first-class frozen config object, so GGUF metadata can be mapped onto it and
the engine can key its per-model choices on it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Static architecture description. Frozen + hashable → usable as a jit
    static argument."""

    arch: str = "llama"
    gguf_arch: str = ""                # raw GGUF source arch ("" = native);
                                       # rope-layout decisions key on this,
                                       # NOT on the normalized arch (qwen2/
                                       # gemma map to arch="llama" but are
                                       # not interleaved-rope)
    vocab_size: int = 32000
    dim: int = 4096                    # model/residual width
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32               # < n_heads → GQA
    head_dim: int = 128
    ffn_dim: int = 11008               # hidden width of the MLP
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    # context-extension rope scaling (ops/rope.scaled_inv_freq): the scheme
    # llama.cpp reads from GGUF rope.scaling.* metadata / the rope_freqs
    # tensor of llama3.1-family conversions
    rope_scaling_type: str = "none"    # none | linear | yarn | llama3
    rope_scaling: float = 1.0          # the scaling factor (1.0 = off);
                                       # with type "none" a non-1 factor is
                                       # honored as linear (legacy field)
    rope_orig_ctx: int = 0             # original (pre-extension) context
    rope_attn_factor: float = 0.0      # yarn cos/sin magnitude; 0 = auto
    rope_low_freq_factor: float = 1.0  # llama3 interpolation band
    rope_high_freq_factor: float = 4.0
    rope_yarn_beta_fast: float = 32.0  # yarn correction-dim betas
    rope_yarn_beta_slow: float = 1.0
    # per-frequency factors from a GGUF rope_freqs.weight tensor
    # (llama3.1-family conversions bake their scheme into this); tuple so
    # the config stays hashable for jit static args
    rope_freq_factors: Optional[Tuple[float, ...]] = None
    rotary_pct: float = 1.0            # phi-2 rotates only part of head_dim
    max_seq_len: int = 4096
    sliding_window: int = 0            # 0 = full attention (mistral: 4096)
    # block structure
    norm_type: str = "rmsnorm"         # "rmsnorm" | "layernorm"
    norm_bias: bool = True             # layernorm only; command-r stores
                                       # NO norm biases
    norm_weight_offset: float = 0.0    # gemma: weight stored as (w - 1)
    mlp_type: str = "gated"            # "gated" (silu/gelu gate*up) | "plain"
    act: str = "silu"                  # "silu" | "gelu" | "gelu_tanh"
    parallel_block: bool = False       # phi-2: attn and mlp share the input LN
    attn_bias: bool = False            # qwen2/phi-2: bias on q/k/v
    out_bias: bool = False             # phi-2: bias on o/mlp projections
    tie_embeddings: bool = False       # share tok_emb and lm_head
    emb_scale: bool = False            # gemma: scale embeddings by sqrt(dim)
    logit_softcap: float = 0.0         # gemma2: tanh soft-capping of logits
    attn_softcap: float = 0.0          # gemma2: tanh soft-capping of scores
    post_norms: bool = False           # gemma2: sandwich norms — extra RMS
                                       # on attn/mlp OUTPUTS before the
                                       # residual adds
    altern_sliding: bool = False       # gemma2/gemma3: layers alternate
                                       # sliding-window and full attention
                                       # (einsum path only)
    sliding_pattern: int = 2           # alternation period: layer i runs
                                       # FULL attention iff
                                       # i % pattern == pattern - 1
                                       # (gemma2: 2 — odd layers full;
                                       # gemma3: 6 — every 6th layer full)
    rope_local_theta: float = 0.0      # gemma3: SLIDING layers rope at
                                       # this theta with no scaling; full
                                       # layers use rope_theta + scaling.
                                       # 0 = one rope for all layers
    attn_scale: float = 0.0            # gemma2 query_pre_attn_scalar:
                                       # scores scale 1/sqrt(this);
                                       # 0 = 1/sqrt(head_dim)
    qk_norm: bool = False              # qwen3/llama4-style per-head RMS on q,k
    # granite-family scalar multipliers (0 = off)
    emb_multiplier: float = 0.0        # embeddings scaled by this
    residual_multiplier: float = 0.0   # block outputs scaled before the
                                       # residual adds
    logit_scale: float = 0.0           # final logits DIVIDED by this
    attn_scale_mult: float = 0.0       # exact score multiplier (granite
                                       # attention_multiplier); overrides
                                       # the 1/sqrt(attn_scale|head_dim)
                                       # convention when set
    # mixture-of-experts (mixtral family); 0 experts = dense MLP
    n_experts: int = 0                 # total routed experts per layer
    n_experts_used: int = 2            # top-k experts per token
    moe_renorm: bool = True            # softmax over the SELECTED top-k
                                       # (mixtral/qwen3moe); False = full
                                       # softmax, top-k gates kept as-is
                                       # (qwen2moe norm_topk_prob=false)
    n_shared_ffn: int = 0              # qwen2moe: a SHARED gated expert
                                       # of this ffn width runs for every
                                       # token, scaled by a sigmoid gate
    moe_impl: str = "auto"             # auto|einsum|scan (models/decoder.py)
    kernels: str = "auto"              # attention impl: auto|pallas|xla|interpret
    mm_kernels: str = "auto"           # quantized-matmul impl. "auto" = XLA
                                       # (the grouped einsum measured faster
                                       # than the fused kernel for int8 on
                                       # v5e); the int4 loader sets "pallas"
                                       # on single-device TPU — only the
                                       # kernel reads packed bytes once, the
                                       # XLA int4 path reads them twice

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def rotary_dim(self) -> int:
        rd = int(self.head_dim * self.rotary_pct)
        return rd - rd % 2

    @property
    def n_params(self) -> int:
        """Approximate parameter count (for sizing / logs)."""
        d, f, l, v = self.dim, self.ffn_dim, self.n_layers, self.vocab_size
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        mlp = 3 * d * f if self.mlp_type == "gated" else 2 * d * f
        if self.n_experts:
            mlp = self.n_experts * mlp + d * self.n_experts
        emb = v * d * (1 if self.tie_embeddings else 2)
        return l * (attn + mlp) + emb

    def validate(self) -> "ModelConfig":
        assert self.n_heads % self.n_kv_heads == 0, "GQA requires n_heads % n_kv_heads == 0"
        assert self.rope_scaling_type in ("none", "linear", "yarn", "llama3")
        if self.rope_freq_factors is not None:
            # JSON round-trips (gguf/store.py meta) hand back a list; the
            # config must stay hashable for jit static args
            object.__setattr__(self, "rope_freq_factors",
                               tuple(float(x)
                                     for x in self.rope_freq_factors))
            assert len(self.rope_freq_factors) == self.rotary_dim // 2, (
                f"rope_freq_factors: {len(self.rope_freq_factors)} entries "
                f"for rotary_dim {self.rotary_dim}")
        if self.rope_scaling_type in ("yarn", "llama3"):
            assert self.rope_orig_ctx > 0, (
                f"{self.rope_scaling_type} rope scaling requires "
                "rope_orig_ctx")
        assert self.norm_type in ("rmsnorm", "layernorm")
        assert self.mlp_type in ("gated", "plain")
        assert self.act in ("silu", "gelu", "gelu_tanh")
        assert self.kernels in ("auto", "pallas", "xla", "interpret")
        assert self.mm_kernels in ("auto", "pallas", "xla", "interpret")
        assert self.moe_impl in ("auto", "einsum", "scan")
        if self.n_experts:
            assert self.mlp_type == "gated", "MoE is gated-MLP only"
            assert 0 < self.n_experts_used <= self.n_experts
        if self.rope_local_theta:
            assert self.altern_sliding, (
                "rope_local_theta pairs with per-layer (altern_sliding) "
                "attention — the dual rope selects by the same pattern")
        assert self.sliding_pattern >= 2
        return self


def resolve_moe_impl(cfg: ModelConfig) -> str:
    """The MoE layout an engine serves ``cfg`` with: the JAX package's
    ``resolve_moe_impl`` with no mesh. Its one rule (the einsum layout
    whenever the experts are sharded over an "ep" axis) needs a mesh, and
    the port serves one device, so the configured ``moe_impl`` stands."""
    return cfg.moe_impl


def _mk(**kw) -> ModelConfig:
    return ModelConfig(**kw).validate()


# --- presets -----------------------------------------------------------------
# Dims cross-checked against the public GGUF metadata of the ollama library
# images listed in the upstream operator's README model table.

PRESETS = {
    # tiny config for unit tests / CI (CPU mesh)
    "tiny": _mk(arch="llama", vocab_size=256, dim=64, n_layers=2, n_heads=4,
                n_kv_heads=2, head_dim=16, ffn_dim=128, max_seq_len=128),
    "tinyllama": _mk(arch="llama", vocab_size=32000, dim=2048, n_layers=22,
                     n_heads=32, n_kv_heads=4, head_dim=64, ffn_dim=5632,
                     max_seq_len=2048),
    "phi": _mk(arch="phi2", vocab_size=51200, dim=2560, n_layers=32,
               n_heads=32, n_kv_heads=32, head_dim=80, ffn_dim=10240,
               norm_type="layernorm", mlp_type="plain", act="gelu_tanh",
               parallel_block=True, attn_bias=True, out_bias=True,
               rotary_pct=0.4, max_seq_len=2048),
    # phi3-mini 3.8B (the ollama `phi3` default tag): llama-family block,
    # MHA (32/32), full rotary; the 4k-instruct variant serves without
    # longrope (the 128k tags carry rope_factors tensors the transcoder
    # maps to rope_freq_factors)
    "phi3": _mk(arch="llama", vocab_size=32064, dim=3072, n_layers=32,
                n_heads=32, n_kv_heads=32, head_dim=96, ffn_dim=8192,
                max_seq_len=4096, sliding_window=2047),
    # gemma3-4b (the ollama `gemma3` default tag): pattern-6 alternating
    # attention with DUAL rope (local 10k on sliding layers, global 1e6
    # linear-scaled ×8 on full layers), gemma-offset qk norms, sandwich
    # norms, no softcapping
    "gemma3": _mk(arch="llama", vocab_size=262208, dim=2560, n_layers=34,
                  n_heads=8, n_kv_heads=4, head_dim=256, ffn_dim=10240,
                  act="gelu_tanh", emb_scale=True, tie_embeddings=True,
                  norm_weight_offset=1.0, post_norms=True,
                  altern_sliding=True, sliding_pattern=6, qk_norm=True,
                  sliding_window=1024, rope_local_theta=10000.0,
                  rope_theta=1000000.0, rope_scaling_type="linear",
                  rope_scaling=8.0, attn_scale=256.0,
                  max_seq_len=131072),
    # starcoder2-3b (the ollama `starcoder2` default tag): LayerNorm +
    # biases, plain gelu MLP, GQA 12:1, sliding window
    "starcoder2": _mk(arch="llama", vocab_size=49152, dim=3072,
                      n_layers=30, n_heads=24, n_kv_heads=2, head_dim=128,
                      ffn_dim=12288, norm_type="layernorm",
                      mlp_type="plain", act="gelu_tanh", attn_bias=True,
                      out_bias=True, tie_embeddings=True,
                      max_seq_len=16384, sliding_window=4096,
                      rope_theta=999999.0),
    "llama2": _mk(arch="llama", vocab_size=32000, dim=4096, n_layers=32,
                  n_heads=32, n_kv_heads=32, head_dim=128, ffn_dim=11008,
                  max_seq_len=4096),
    "llama2:13b": _mk(arch="llama", vocab_size=32000, dim=5120, n_layers=40,
                      n_heads=40, n_kv_heads=40, head_dim=128, ffn_dim=13824,
                      max_seq_len=4096),
    "llama2:70b": _mk(arch="llama", vocab_size=32000, dim=8192, n_layers=80,
                      n_heads=64, n_kv_heads=8, head_dim=128, ffn_dim=28672,
                      max_seq_len=4096),
    "llama3": _mk(arch="llama", vocab_size=128256, dim=4096, n_layers=32,
                  n_heads=32, n_kv_heads=8, head_dim=128, ffn_dim=14336,
                  rope_theta=500000.0, max_seq_len=8192),
    "llama3:70b": _mk(arch="llama", vocab_size=128256, dim=8192, n_layers=80,
                      n_heads=64, n_kv_heads=8, head_dim=128, ffn_dim=28672,
                      rope_theta=500000.0, max_seq_len=8192),
    # llama3.1 shares llama3-8B dims; the 131072 context comes from
    # llama3-type rope scaling (ops/rope.scaled_inv_freq) — factor 8 over
    # the 8192 native window, low/high-freq interpolation band 1..4 (real
    # GGUF pulls carry the equivalent pre-baked rope_freqs tensor, which
    # the transcoder reads into rope_freq_factors). 3.2 are the small GQA
    # variants — factor 32, tied embeddings.
    "llama3.1": _mk(arch="llama", vocab_size=128256, dim=4096, n_layers=32,
                    n_heads=32, n_kv_heads=8, head_dim=128, ffn_dim=14336,
                    rope_theta=500000.0, rope_scaling_type="llama3",
                    rope_scaling=8.0, rope_orig_ctx=8192,
                    rope_low_freq_factor=1.0, rope_high_freq_factor=4.0,
                    max_seq_len=131072),
    "llama3.2:1b": _mk(arch="llama", vocab_size=128256, dim=2048,
                       n_layers=16, n_heads=32, n_kv_heads=8, head_dim=64,
                       ffn_dim=8192, rope_theta=500000.0,
                       rope_scaling_type="llama3", rope_scaling=32.0,
                       rope_orig_ctx=8192, rope_low_freq_factor=1.0,
                       rope_high_freq_factor=4.0,
                       tie_embeddings=True, max_seq_len=131072),
    "llama3.2:3b": _mk(arch="llama", vocab_size=128256, dim=3072,
                       n_layers=28, n_heads=24, n_kv_heads=8, head_dim=128,
                       ffn_dim=8192, rope_theta=500000.0,
                       rope_scaling_type="llama3", rope_scaling=32.0,
                       rope_orig_ctx=8192, rope_low_freq_factor=1.0,
                       rope_high_freq_factor=4.0,
                       tie_embeddings=True, max_seq_len=131072),
    "mistral": _mk(arch="llama", vocab_size=32000, dim=4096, n_layers=32,
                   n_heads=32, n_kv_heads=8, head_dim=128, ffn_dim=14336,
                   sliding_window=4096, max_seq_len=32768),
    "gemma2": _mk(arch="llama", vocab_size=256000, dim=3584, n_layers=42,
                  n_heads=16, n_kv_heads=8, head_dim=256, ffn_dim=14336,
                  act="gelu_tanh", emb_scale=True, tie_embeddings=True,
                  norm_weight_offset=1.0, post_norms=True,
                  altern_sliding=True, sliding_window=4096,
                  attn_softcap=50.0, logit_softcap=30.0,
                  max_seq_len=8192),
    "gemma2:27b": _mk(arch="llama", vocab_size=256000, dim=4608,
                      n_layers=46, n_heads=32, n_kv_heads=16, head_dim=128,
                      ffn_dim=36864, act="gelu_tanh", emb_scale=True,
                      tie_embeddings=True, norm_weight_offset=1.0,
                      post_norms=True, altern_sliding=True,
                      sliding_window=4096, attn_softcap=50.0,
                      logit_softcap=30.0, attn_scale=144.0,
                      max_seq_len=8192),
    "qwen3": _mk(arch="llama", vocab_size=151936, dim=4096, n_layers=36,
                 n_heads=32, n_kv_heads=8, head_dim=128, ffn_dim=12288,
                 qk_norm=True, rope_theta=1000000.0, max_seq_len=32768),
    "qwen2": _mk(arch="llama", vocab_size=152064, dim=3584, n_layers=28,
                 n_heads=28, n_kv_heads=4, head_dim=128, ffn_dim=18944,
                 attn_bias=True, rope_theta=1000000.0, max_seq_len=32768),
    # qwen2.5-7B keeps qwen2-7B's architecture/dims
    "qwen2.5": _mk(arch="llama", vocab_size=152064, dim=3584, n_layers=28,
                   n_heads=28, n_kv_heads=4, head_dim=128, ffn_dim=18944,
                   attn_bias=True, rope_theta=1000000.0,
                   max_seq_len=32768),
    "qwen2:0.5b": _mk(arch="llama", vocab_size=151936, dim=896, n_layers=24,
                      n_heads=14, n_kv_heads=2, head_dim=64, ffn_dim=4864,
                      attn_bias=True, tie_embeddings=True,
                      rope_theta=1000000.0, max_seq_len=32768),
    "gemma": _mk(arch="llama", vocab_size=256000, dim=3072, n_layers=28,
                 n_heads=16, n_kv_heads=16, head_dim=256, ffn_dim=24576,
                 act="gelu_tanh", emb_scale=True, tie_embeddings=True,
                 norm_weight_offset=1.0, max_seq_len=8192),
    # multimodal (vicuna-7b LLM half of llava-1.5; vision tower in
    # models/vision.py via the mmproj layer)
    "llava": _mk(arch="llama", vocab_size=32000, dim=4096, n_layers=32,
                 n_heads=32, n_kv_heads=32, head_dim=128, ffn_dim=11008,
                 max_seq_len=4096),
    # mixture-of-experts family (sparse MoE; expert-parallel over "ep")
    "tiny-moe": _mk(arch="llama", vocab_size=256, dim=64, n_layers=2,
                    n_heads=4, n_kv_heads=2, head_dim=16, ffn_dim=128,
                    n_experts=4, n_experts_used=2, max_seq_len=128),
    "mixtral": _mk(arch="llama", vocab_size=32000, dim=4096, n_layers=32,
                   n_heads=32, n_kv_heads=8, head_dim=128, ffn_dim=14336,
                   n_experts=8, n_experts_used=2, rope_theta=1000000.0,
                   max_seq_len=32768),
    "mixtral:8x22b": _mk(arch="llama", vocab_size=32768, dim=6144,
                         n_layers=56, n_heads=48, n_kv_heads=8, head_dim=128,
                         ffn_dim=16384, n_experts=8, n_experts_used=2,
                         rope_theta=1000000.0, max_seq_len=65536),
    "dolphin-mixtral": _mk(arch="llama", vocab_size=32002, dim=4096,
                           n_layers=32, n_heads=32, n_kv_heads=8,
                           head_dim=128, ffn_dim=14336, n_experts=8,
                           n_experts_used=2, rope_theta=1000000.0,
                           max_seq_len=32768),
}


def get_config(name: str) -> ModelConfig:
    base = name.split(":")[0]
    if name in PRESETS:
        return PRESETS[name]
    if base in PRESETS:
        return PRESETS[base]
    raise KeyError(f"unknown model preset: {name!r}; known: {sorted(PRESETS)}")
