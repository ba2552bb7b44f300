"""GGUFs of the other dense families, pulled and served by the port's
``ModelManager`` on the CPU, against the JAX package's.

Each family's tiny config of ``tests/test_torch_families.py`` (random norm
weights and biases) is written as a GGUF of its own architecture with the
port's ``gguf/writer.py``, under llama.cpp's tensor names and metadata
keys (NEOX-layout q/k, so no permutation: ``qwen3``, ``gemma2``,
``gemma3`` with its linear rope scaling, ``starcoder2``, ``phi2`` with
its fused ``attn_qkv``), f32 tensors. A loopback registry
(``tests/fake_registry.py``) serves them; the port's and the JAX
package's model managers pull each into their own store, load it through
the transcode cache (f32 on the CPU) and serve it: the same config, the
same greedy streams, and first-token logits within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fake_registry import FakeRegistry
from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.server import app as japp
from ollama_operator_tpu_torch.gguf import writer as W
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.server import app as tapp
from test_torch_families import configs, family_params
from test_torch_registry import BYTES_MD, _ecfg, _ref

torch.set_num_threads(1)

ARCH = {"qwen3": "qwen3", "gemma2": "gemma2", "gemma3": "gemma3",
        "starcoder2": "starcoder2", "phi2": "phi2"}
PARAMS = {"temperature": 0, "num_predict": 10}
PROMPTS = ["the quick brown fox jumps over", "pull, then serve"]


def write_family_gguf(path: str, name: str) -> str:
    """The family's tiny model as a GGUF of its architecture."""
    _, cfg = configs(name)
    arch = ARCH[name]
    p = {k: (v.numpy() if not isinstance(v, dict)
             else {kk: vv.numpy() for kk, vv in v.items()})
         for k, v in family_params(name)[1].items()}
    w = W.GGUFWriter(path)
    meta = {"block_count": cfg.n_layers, "embedding_length": cfg.dim,
            "attention.head_count": cfg.n_heads,
            "attention.head_count_kv": cfg.n_kv_heads,
            "attention.key_length": cfg.head_dim,
            "feed_forward_length": cfg.ffn_dim,
            "context_length": cfg.max_seq_len,
            "rope.freq_base": cfg.rope_theta}
    eps = ("attention.layer_norm_epsilon" if cfg.norm_type == "layernorm"
           else "attention.layer_norm_rms_epsilon")
    meta[eps] = cfg.norm_eps
    if cfg.sliding_window:
        meta["attention.sliding_window"] = cfg.sliding_window
    if arch == "gemma2":
        meta.update({"attn_logit_softcapping": cfg.attn_softcap,
                     "final_logit_softcapping": cfg.logit_softcap})
    if cfg.attn_scale:
        meta["attention.query_pre_attn_scalar"] = cfg.attn_scale
    if cfg.rope_scaling_type == "linear":
        meta.update({"rope.scaling.type": "linear",
                     "rope.scaling.factor": cfg.rope_scaling})
    if arch == "phi2":
        meta["rope.dimension_count"] = cfg.rotary_dim
    w.add_meta("general.architecture", arch)
    for k, v in meta.items():
        w.add_meta(f"{arch}.{k}", v)
    for k, v in BYTES_MD.items():
        w.add_meta(k, v)

    def put(n, a):
        w.add_tensor_f32(n, np.ascontiguousarray(a, np.float32))

    put("token_embd.weight", p["tok_emb"])
    put("output_norm.weight", p["out_norm_w"])
    if "out_norm_b" in p:
        put("output_norm.bias", p["out_norm_b"])
    if "lm_head" in p:
        put("output.weight", p["lm_head"].T)
    if "lm_head_b" in p:
        put("output.bias", p["lm_head_b"])
    lp = p["layers"]
    names = {"attn_norm_w": "attn_norm.weight", "attn_norm_b":
             "attn_norm.bias", "wo": "attn_output.weight", "bo":
             "attn_output.bias", "mlp_norm_w": "ffn_norm.weight",
             "mlp_norm_b": "ffn_norm.bias", "w_gate": "ffn_gate.weight",
             "w_up": "ffn_up.weight", "b_up": "ffn_up.bias",
             "w_down": "ffn_down.weight", "b_down": "ffn_down.bias",
             "q_norm_w": "attn_q_norm.weight",
             "k_norm_w": "attn_k_norm.weight",
             "post_attn_norm_w": "post_attention_norm.weight",
             "post_ffw_norm_w": "post_ffw_norm.weight"}
    if arch != "phi2":
        names.update(wq="attn_q.weight", wk="attn_k.weight",
                     wv="attn_v.weight", bq="attn_q.bias",
                     bk="attn_k.bias", bv="attn_v.bias")
    for i in range(cfg.n_layers):
        for key, gname in names.items():
            if key in lp:
                a = lp[key][i]
                put(f"blk.{i}.{gname}", a.T if a.ndim == 2 else a)
        if arch == "phi2":   # llama.cpp's phi2 conversion fuses q, k, v
            put(f"blk.{i}.attn_qkv.weight", np.concatenate(
                [lp[k][i].T for k in ("wq", "wk", "wv")]))
            put(f"blk.{i}.attn_qkv.bias", np.concatenate(
                [lp[k][i] for k in ("bq", "bk", "bv")]))
    w.write()
    return path


@pytest.fixture(scope="module")
def family_registry(tmp_path_factory):
    d = tmp_path_factory.mktemp("families")
    reg = FakeRegistry()
    for name in ARCH:
        with open(write_family_gguf(str(d / f"{name}.gguf"), name),
                  "rb") as f:
            reg.add_model("library", name, "latest", f.read(),
                          template="{{ .Prompt }}", params=PARAMS)
    url = reg.start()
    yield url.split("://", 1)[1]
    reg.stop()


def first_logits(lm, ids, jax_side):
    toks = np.asarray(ids, np.int64)[None]
    if jax_side:
        logits, _, _ = jdec.prefill_chunk(lm.engine.params, lm.cfg,
                                          jnp.asarray(toks, jnp.int32))
        return np.asarray(logits[0, -1], np.float32)
    logits, _, _ = tdec.prefill_chunk(lm.engine.params, lm.cfg,
                                      torch.from_numpy(toks))
    return logits[0, -1].numpy()


@pytest.mark.parametrize("name", sorted(ARCH))
def test_pulled_family_gguf_serves_the_jax_streams(name, family_registry,
                                                   tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_WARM_BUCKETS", "0")
    ref = _ref(family_registry, name)
    port = tapp.ModelManager(str(tmp_path / "port"),
                             cache_dir=str(tmp_path / "pc"), device="cpu",
                             ecfg=_ecfg(False), engine_dtype=None)
    jm = japp.ModelManager(str(tmp_path / "jax"),
                           cache_dir=str(tmp_path / "jc"), ecfg=_ecfg(True),
                           engine_dtype=None)
    try:
        port.pull(ref)
        jm.client.pull(ref)
        lm, jlm = port.load(ref), jm.load(ref)
        assert lm.serving_dtype == jlm.serving_dtype == "float32"
        assert lm.cfg.__dict__ == jlm.cfg.__dict__
        assert set(lm.engine.params["layers"]) == set(
            jlm.engine.params["layers"])
        for prompt in PROMPTS:
            got, want = lm.generate(prompt), jlm.generate(prompt)
            assert got.generated_tokens == want.generated_tokens == 10
            assert got.context == want.context
            ids = lm.tokenizer.encode(prompt)
            np.testing.assert_allclose(first_logits(lm, ids, False),
                                       first_logits(jlm, ids, True),
                                       rtol=1e-4, atol=1e-4)
    finally:
        port.shutdown()
        jm.unload_now()
        jm.shutdown()
