"""Mixture-of-experts GGUFs through the port's transcode and server, against
the JAX package's, on the CPU.

The configs of ``tests/test_torch_moe.py`` are written from a seed as
GGUFs of their own architectures with the port's ``gguf/writer.py``,
under llama.cpp's tensor names and metadata keys, f32 tensors:

- mixtral: arch ``llama`` with ``expert_count``, interleaved-rope q/k,
  merged ``ffn_{gate,up,down}_exps`` tensors, and again as a legacy GGUF
  of split ``ffn_{gate,up,down}.{e}`` tensors;
- qwen2moe: qkv biases, the shared expert ``ffn_*_shexp`` and its gate
  ``ffn_gate_inp_shexp``, ``expert_shared_feed_forward_length``;
- qwen3moe: qk norms.

The two qwen GGUFs carry the dense width in ``feed_forward_length`` and
the experts' own in ``expert_feed_forward_length``, as llama.cpp's
converter writes both for these archs: both packages take ``ffn_dim``
from the first, and the experts' width from their tensors.

The port's ``config_from_gguf`` + ``load_params`` equal the JAX
transcode's, config field by field and every array bit for bit in f32. A
GGUF without its expert tensors fails to load with the missing tensor's
name. The qwen3moe GGUF, pulled from a loopback registry into a store, is
served by both packages' HTTP servers: the same ``/api/generate`` text,
``/api/show`` and the model block of ``/api/ps``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fake_registry import FakeRegistry
from ollama_operator_tpu.gguf import reader as JR
from ollama_operator_tpu.gguf import transcode as JTC
from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.server import app as japp
from ollama_operator_tpu_torch.gguf import reader as R
from ollama_operator_tpu_torch.gguf import transcode as TC
from ollama_operator_tpu_torch.gguf import writer as W
from ollama_operator_tpu_torch.server import app as tapp
from test_torch_moe import configs
from test_torch_registry import BYTES_MD, _call, _ecfg, _json, _ref
from test_transcode import permute_to_interleaved

torch.set_num_threads(1)

ARCH = {"mixtral": "llama", "qwen2moe": "qwen2moe", "qwen3moe": "qwen3moe"}
GGUFS = {"mixtral": ("mixtral", True), "mixtral_legacy": ("mixtral", False),
         "qwen2moe": ("qwen2moe", True), "qwen3moe": ("qwen3moe", True)}
PARAMS = {"temperature": 0, "num_predict": 10}
PROMPTS = ["the quick brown fox jumps over", "experts, then serve"]


def moe_tree(name: str):
    """The config's weights from a seed (the JAX init), f32 numpy, with
    random norm weights and biases, so that every leaf moves the output."""
    jc, _ = configs(name)
    p = jax.tree_util.tree_map(np.asarray, jdec.init_params(
        jc, jax.random.key(40 + len(name)), jnp.float32))
    rng = np.random.default_rng(41)
    for k, v in p["layers"].items():
        if k.endswith("norm_w") or k in ("bq", "bk", "bv"):
            p["layers"][k] = (v + rng.normal(0.0, 0.2, v.shape)
                              ).astype(np.float32)
    return p


def write_moe_gguf(path: str, name: str, merged: bool = True) -> str:
    """The config's tiny model as a GGUF of its architecture."""
    _, cfg = configs(name)
    arch = ARCH[name]
    p = moe_tree(name)
    # the qwen archs' feed_forward_length is the dense width, not the
    # experts' (expert_feed_forward_length)
    dense_ffn = cfg.ffn_dim if arch == "llama" else 2 * cfg.ffn_dim
    meta = {"block_count": cfg.n_layers, "embedding_length": cfg.dim,
            "attention.head_count": cfg.n_heads,
            "attention.head_count_kv": cfg.n_kv_heads,
            "attention.key_length": cfg.head_dim,
            "feed_forward_length": dense_ffn,
            "context_length": cfg.max_seq_len,
            "rope.freq_base": cfg.rope_theta,
            "attention.layer_norm_rms_epsilon": cfg.norm_eps,
            "expert_count": cfg.n_experts,
            "expert_used_count": cfg.n_experts_used}
    if arch != "llama":
        meta["expert_feed_forward_length"] = cfg.ffn_dim
    if cfg.n_shared_ffn:
        meta["expert_shared_feed_forward_length"] = cfg.n_shared_ffn
    w = W.GGUFWriter(path)
    w.add_meta("general.architecture", arch)
    for k, v in meta.items():
        w.add_meta(f"{arch}.{k}", v)
    for k, v in BYTES_MD.items():
        w.add_meta(k, v)

    def put(n, a):
        w.add_tensor_f32(n, np.ascontiguousarray(a, np.float32))

    put("token_embd.weight", p["tok_emb"])
    put("output_norm.weight", p["out_norm_w"])
    put("output.weight", p["lm_head"].T)
    lp = p["layers"]
    for i in range(cfg.n_layers):
        pre = f"blk.{i}."
        wq, wk = lp["wq"][i].T, lp["wk"][i].T
        bq, bk = (lp["bq"][i], lp["bk"][i]) if "bq" in lp else (None, None)
        if arch == "llama":
            wq = permute_to_interleaved(wq, cfg.n_heads)
            wk = permute_to_interleaved(wk, cfg.n_kv_heads)
        put(pre + "attn_norm.weight", lp["attn_norm_w"][i])
        put(pre + "attn_q.weight", wq)
        put(pre + "attn_k.weight", wk)
        put(pre + "attn_v.weight", lp["wv"][i].T)
        put(pre + "attn_output.weight", lp["wo"][i].T)
        if bq is not None:
            put(pre + "attn_q.bias", bq)
            put(pre + "attn_k.bias", bk)
            put(pre + "attn_v.bias", lp["bv"][i])
        if cfg.qk_norm:
            put(pre + "attn_q_norm.weight", lp["q_norm_w"][i])
            put(pre + "attn_k_norm.weight", lp["k_norm_w"][i])
        put(pre + "ffn_norm.weight", lp["mlp_norm_w"][i])
        put(pre + "ffn_gate_inp.weight", lp["router"][i].T)
        for key, part in (("we_gate", "gate"), ("we_up", "up"),
                          ("we_down", "down")):
            if merged:   # ggml's [E, out, in]
                put(pre + f"ffn_{part}_exps.weight",
                    lp[key][i].transpose(0, 2, 1))
            else:
                for e in range(cfg.n_experts):
                    put(pre + f"ffn_{part}.{e}.weight", lp[key][i, e].T)
        if cfg.n_shared_ffn:
            for key, gname in (("we_sh_gate", "ffn_gate_shexp"),
                               ("we_sh_up", "ffn_up_shexp"),
                               ("we_sh_down", "ffn_down_shexp"),
                               ("sh_gate", "ffn_gate_inp_shexp")):
                put(pre + f"{gname}.weight", lp[key][i].T)
    w.write()
    return path


@pytest.fixture(scope="module")
def moe_ggufs(tmp_path_factory):
    d = tmp_path_factory.mktemp("moe_gguf")
    return {k: write_moe_gguf(str(d / f"{k}.gguf"), name, merged)
            for k, (name, merged) in GGUFS.items()}


@pytest.mark.parametrize("which", sorted(GGUFS))
def test_transcode_equals_the_jax_transcode(moe_ggufs, which):
    path = moe_ggufs[which]
    name = GGUFS[which][0]
    with R.GGUFFile(path) as f:
        cfg = TC.config_from_gguf(f)
        params = TC.load_params(f, cfg, "float32")
    with JR.GGUFFile(path) as f:
        jcfg = JTC.config_from_gguf(f)
        jparams = JTC.load_params(f, jcfg, np.float32)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    want = configs(name)[1]
    assert (cfg.n_experts, cfg.n_experts_used, cfg.moe_renorm,
            cfg.n_shared_ffn, cfg.qk_norm, cfg.attn_bias) == (
        want.n_experts, want.n_experts_used, want.moe_renorm,
        want.n_shared_ffn, want.qk_norm, want.attn_bias)
    # the qwen archs' ffn_dim is feed_forward_length, the dense width;
    # the experts' width comes from their tensors
    assert cfg.ffn_dim == (want.ffn_dim if name == "mixtral"
                           else 2 * want.ffn_dim)
    assert params["layers"]["we_gate"].shape[-1] == want.ffn_dim
    flat = dict(TC._flatten(params))
    jflat = dict(TC._flatten(jparams))
    assert sorted(flat) == sorted(jflat)
    assert not any(k.startswith("layers/w_") for k in flat)
    for k, v in flat.items():
        assert v.dtype == np.float32 and v.shape == jflat[k].shape, k
        np.testing.assert_array_equal(v, jflat[k], err_msg=k)
    # the tree is the weights the GGUF was written from
    tree = moe_tree(name)
    for k in ("router", "we_gate", "we_up", "we_down", "wq"):
        np.testing.assert_array_equal(params["layers"][k], tree["layers"][k])


def without_experts(src: str, path: str) -> str:
    """A copy of the GGUF ``src`` without its merged expert tensors."""
    with R.GGUFFile(src) as f:
        w = W.GGUFWriter(path)
        for k, v in f.metadata.items():
            w.add_meta(k, v)
        for n in f.tensors:
            if "_exps" not in n:
                w.add_tensor_f32(n, TC._dq(f, n))
        w.write()
    return path


def test_missing_expert_tensors_name_the_tensor(moe_ggufs, tmp_path):
    """A qwen3moe GGUF whose expert tensors are gone, and a legacy one
    short of an expert: the transcode raises KeyError naming the first
    missing tensor."""
    path = without_experts(moe_ggufs["qwen3moe"],
                           str(tmp_path / "no_experts.gguf"))
    with R.GGUFFile(path) as f:
        with pytest.raises(KeyError, match="ffn_gate_exps"):
            TC.load_params(f, TC.config_from_gguf(f), "float32")
    with R.GGUFFile(moe_ggufs["mixtral_legacy"]) as f:
        cfg = dataclasses.replace(TC.config_from_gguf(f), n_experts=5)
        with pytest.raises(KeyError, match=r"blk\.0\.ffn_gate\.4\.weight"):
            TC.load_params(f, cfg, "float32")


@pytest.fixture(scope="module")
def moe_registry(moe_ggufs, tmp_path_factory):
    reg = FakeRegistry()
    broken = without_experts(moe_ggufs["qwen3moe"], str(
        tmp_path_factory.mktemp("noexp") / "noexp.gguf"))
    for name, path in (("qwen3moe", moe_ggufs["qwen3moe"]),
                       ("noexp", broken)):
        with open(path, "rb") as f:
            reg.add_model("library", name, "latest", f.read(),
                          template="{{ .Prompt }}", params=PARAMS)
    url = reg.start()
    yield url.split("://", 1)[1]
    reg.stop()


def test_pulled_qwen3moe_is_served_as_the_jax_server_serves_it(
        moe_registry, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_WARM_BUCKETS", "0")
    ref = _ref(moe_registry, "qwen3moe")
    port = tapp.ModelManager(str(tmp_path / "port"),
                             cache_dir=str(tmp_path / "pc"), device="cpu",
                             ecfg=_ecfg(False), engine_dtype=None)
    jm = japp.ModelManager(str(tmp_path / "jax"),
                           cache_dir=str(tmp_path / "jc"), ecfg=_ecfg(True),
                           engine_dtype=None)
    servers = [tapp.serve(port, "127.0.0.1", 0),
               japp.serve(jm, "127.0.0.1", 0)]
    p, j = (s.server_address[1] for s in servers)
    try:
        for http_port in (p, j):
            s, _ = _call(http_port, "POST", "/api/pull",
                         {"model": ref, "stream": False})
            assert s == 200
        for prompt in PROMPTS:
            body = {"model": ref, "prompt": prompt, "stream": False}
            (s1, t1), (s2, t2) = (_call(x, "POST", "/api/generate", body)
                                  for x in (p, j))
            assert s1 == s2 == 200
            a, b = _json(t1), _json(t2)
            assert a["response"] == b["response"]
            assert a["context"] == b["context"]
            assert a["eval_count"] == b["eval_count"] == 10
        lm = port.resident()[0]
        assert lm.cfg.n_experts == 8 and lm.serving_dtype == "float32"
        assert not lm.engine.paged
        (s1, t1), (s2, t2) = (_call(x, "POST", "/api/show", {"model": ref})
                              for x in (p, j))
        assert s1 == s2 == 200
        a, b = _json(t1), _json(t2)
        assert a == b
        assert a["model_info"]["qwen3moe.expert_count"] == 8
        (s1, t1), (s2, t2) = (_call(x, "GET", "/api/ps") for x in (p, j))
        a, b = _json(t1)["models"][0], _json(t2)["models"][0]
        for k in ("name", "model", "size", "digest"):
            assert a[k] == b[k], k
        for k in ("format", "family", "parameter_size", "serving_dtype",
                  "paged"):
            assert a["details"][k] == b["details"][k], k
    finally:
        for s in servers:
            s.shutdown()
            s.server_close()
        port.shutdown()
        jm.unload_now()
        jm.shutdown()


def test_a_moe_gguf_without_experts_fails_its_load_by_name(moe_registry,
                                                           tmp_path):
    """The manager loads a mixture-of-experts GGUF (no 501 refusal); one
    whose expert tensors are missing fails with the missing tensor's
    name, through ``load`` and through ``/api/generate``."""
    ref = _ref(moe_registry, "noexp")
    mm = tapp.ModelManager(str(tmp_path / "s"), cache_dir=str(
        tmp_path / "c"), device="cpu", ecfg=_ecfg(False))
    httpd = tapp.serve(mm, "127.0.0.1", 0)
    try:
        mm.pull(ref)
        with pytest.raises(KeyError, match="ffn_gate_exps"):
            mm.load(ref)
        status, text = _call(httpd.server_address[1], "POST",
                             "/api/generate", {"model": ref, "prompt": "hi"})
        assert status == 500
        err = _json(text)["error"]
        assert "ffn_gate_exps" in err and "mixture of experts" not in err
        assert mm.ps() == []
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()
