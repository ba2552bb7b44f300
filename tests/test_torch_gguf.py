"""The port's GGUF path against the JAX package's, on the CPU.

- dequantization: every ggml type both support is bit-equal on seeded
  blocks whose f16 scales are finite;
- transcode: ``load_model`` gives the JAX tree (the config equal, every
  leaf bit-equal in float32 and in bfloat16, compared as uint16 patterns)
  on tiny llama GGUFs written by the JAX test helper and by the port's
  writer: tied and untied heads, Q4_0 / Q8_0 / F16 tensors, llama3 rope
  scaling (a ``rope_freqs`` tensor);
- the weight cache: ``transcode_to_store`` then ``load_from_store`` gives
  the same tree, and a cache written by either package holds the other's
  files and arrays;
- the port's writer writes the JAX writer's bytes;
- tokenizers: the ``llama`` (scores, byte fallback) and ``gpt2`` (merges)
  vocabularies load from GGUF metadata and encode as the JAX tokenizer.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ollama_operator_tpu.gguf import dequant as JDQ
from ollama_operator_tpu.gguf import reader as JR
from ollama_operator_tpu.gguf import transcode as JTC
from ollama_operator_tpu.gguf import writer as JW
from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.gguf import dequant as DQ
from ollama_operator_tpu_torch.gguf import reader as R
from ollama_operator_tpu_torch.gguf import transcode as TC
from ollama_operator_tpu_torch.gguf import writer as W
from ollama_operator_tpu_torch.ops.rope import scaled_inv_freq
from ollama_operator_tpu_torch.tokenizer import Tokenizer
from test_transcode import permute_to_interleaved, write_tiny_llama_gguf

torch.set_num_threads(1)

SEED = 1414

# (type, block bytes, byte offsets of the block's f16 scale fields)
BLOCKS = [
    (R.GGML_Q4_0, 18, (0,)), (R.GGML_Q4_1, 20, (0, 2)),
    (R.GGML_Q5_0, 22, (0,)), (R.GGML_Q5_1, 24, (0, 2)),
    (R.GGML_Q8_0, 34, (0,)), (R.GGML_Q2_K, 84, (80, 82)),
    (R.GGML_Q3_K, 110, (108,)), (R.GGML_Q4_K, 144, (0, 2)),
    (R.GGML_Q5_K, 176, (0, 2)), (R.GGML_Q6_K, 210, (208,)),
    (R.GGML_IQ4_NL, 18, (0,)), (R.GGML_IQ4_XS, 136, (0,)),
]


def _raw_blocks(rng, nbytes, scale_offsets, n_blocks=64):
    raw = rng.integers(0, 256, size=(n_blocks, nbytes), dtype=np.uint8)
    for off in scale_offsets:
        d = (rng.standard_normal(n_blocks) * 0.05).astype(np.float16)
        raw[:, off:off + 2] = d.view(np.uint8).reshape(n_blocks, 2)
    return raw.reshape(-1)


def _plain_raw(rng, ggml_type, n=512):
    if ggml_type == R.GGML_F32:
        return rng.standard_normal(n).astype(np.float32).view(np.uint8)
    if ggml_type == R.GGML_F16:
        return (rng.standard_normal(n) * 4).astype(np.float16).view(np.uint8)
    if ggml_type == R.GGML_BF16:
        bits = rng.integers(0, 1 << 16, n, dtype=np.uint16)
        bits[(bits & 0x7F80) == 0x7F80] &= 0xBFFF   # no inf / nan
        return bits.view(np.uint8)
    if ggml_type == R.GGML_I8:
        return rng.integers(-128, 128, n, dtype=np.int8).view(np.uint8)
    assert ggml_type == R.GGML_I32
    return rng.integers(-2**31, 2**31, n, dtype=np.int32).view(np.uint8)


def test_supported_types_match():
    assert DQ.supported_types() == JDQ.supported_types()
    assert R.BLOCK_LAYOUT == JR.BLOCK_LAYOUT
    assert R.GGML_TYPE_NAMES == JR.GGML_TYPE_NAMES


@pytest.mark.parametrize("ggml_type", sorted(DQ.supported_types()),
                         ids=lambda t: R.GGML_TYPE_NAMES[t])
def test_dequant_bit_equal(ggml_type):
    rng = np.random.default_rng(SEED + ggml_type)
    blocks = {t: (nb, offs) for t, nb, offs in BLOCKS}
    if ggml_type in blocks:
        nb, offs = blocks[ggml_type]
        raw = _raw_blocks(rng, nb, offs)
        be = R.BLOCK_LAYOUT[ggml_type][0]
        shape = (raw.size // nb * be // 32, 32)
    else:
        raw = _plain_raw(rng, ggml_type)
        shape = (raw.size // R.BLOCK_LAYOUT[ggml_type][1],)
    got = DQ.dequantize(raw, ggml_type, shape)
    ref = JDQ.dequantize(raw, ggml_type, shape)
    assert got.dtype == np.float32 and got.shape == shape
    assert np.isfinite(ref).all()
    np.testing.assert_array_equal(got.view(np.uint32), ref.view(np.uint32))


def test_codebook_iquants_refused():
    with pytest.raises(NotImplementedError, match="codebook"):
        DQ.dequantize(np.zeros(66, np.uint8), R.GGML_IQ2_XXS, (256,))


def test_bf16_cast_rounds_as_ml_dtypes():
    """The port's float32 → bf16 cast (torch) gives ml_dtypes' bits,
    subnormals and ties included."""
    rng = np.random.default_rng(SEED)
    x = np.concatenate([
        rng.standard_normal(4096).astype(np.float32),
        (rng.standard_normal(512) * 1e-39).astype(np.float32),  # subnormal
        rng.integers(0, 1 << 32, 4096, dtype=np.uint32).view(np.float32),
        # exact ties: the low 16 bits 0x8000
        (rng.integers(0, 1 << 15, 512, dtype=np.uint32) << 16
         | 0x8000).view(np.float32)])
    x = x[np.isfinite(x)]
    x = x[:x.size // 4 * 4].reshape(-1, 4)
    got = TC.bf16_bits(x.T)
    ref = np.ascontiguousarray(x.T, ml_dtypes.bfloat16).view(np.uint16)
    assert got.flags.c_contiguous and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# GGUF files
# ---------------------------------------------------------------------------

def _tiny_params(seed):
    p = jdec.init_params(JPRESETS["tiny"], jax.random.key(seed), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def _llama3_factors(cfg):
    base, _ = scaled_inv_freq(cfg.head_dim, cfg.rope_theta)
    l3, _ = scaled_inv_freq(cfg.head_dim, cfg.rope_theta,
                            scaling_type="llama3", factor=8.0,
                            orig_ctx=32, low_freq_factor=1.0,
                            high_freq_factor=4.0)
    return (np.asarray(base) / np.asarray(l3)).astype(np.float32)


def write_port_gguf(path, params, *, tied=False, qtype="q4_0",
                    emb="q8_0", llama3=False, norm_f16=False,
                    tokens=None, tokenizer_md=None):
    """A tiny llama GGUF written with the port's writer: the 2-D weights
    in ``qtype`` ("q4_0", "q8_0", "f16" or "f32"), ``token_embd`` in
    ``emb``, the head tied (no ``output.weight``) or not, llama3 rope
    scaling as a ``rope_freqs`` tensor."""
    cfg = JPRESETS["tiny"]
    w = W.GGUFWriter(path)
    for k, v in (("general.architecture", "llama"),
                 ("llama.block_count", cfg.n_layers),
                 ("llama.embedding_length", cfg.dim),
                 ("llama.attention.head_count", cfg.n_heads),
                 ("llama.attention.head_count_kv", cfg.n_kv_heads),
                 ("llama.attention.key_length", cfg.head_dim),
                 ("llama.feed_forward_length", cfg.ffn_dim),
                 ("llama.context_length", cfg.max_seq_len),
                 ("llama.rope.freq_base", cfg.rope_theta),
                 ("llama.attention.layer_norm_rms_epsilon", cfg.norm_eps),
                 ("general.file_type", 2)):
        w.add_meta(k, v)
    if tokenizer_md is None:
        tokenizer_md = {
            "tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": tokens or [f"t{i}" for i in range(
                cfg.vocab_size)],
            "tokenizer.ggml.scores": [0.0] * cfg.vocab_size,
            "tokenizer.ggml.token_type": [1] * cfg.vocab_size}
    for k, v in tokenizer_md.items():
        w.add_meta(k, v)

    def put(name, a, kind):
        a = np.ascontiguousarray(a, np.float32)
        if kind == "f32":
            w.add_tensor_f32(name, a)
        elif kind == "f16":
            w.add_tensor_f16(name, a)
        else:
            quant = {"q4_0": W.quantize_q4_0, "q8_0": W.quantize_q8_0}[kind]
            t = {"q4_0": R.GGML_Q4_0, "q8_0": R.GGML_Q8_0}[kind]
            w.add_tensor_raw(name, a.shape, t, quant(a))

    put("token_embd.weight", params["tok_emb"], emb)
    put("output_norm.weight", params["out_norm_w"], "f32")
    if not tied:
        put("output.weight", params["lm_head"].T, qtype)
    if llama3:
        w.add_tensor_f32("rope_freqs.weight", _llama3_factors(cfg))
    lp = params["layers"]
    norm = "f16" if norm_f16 else "f32"
    for i in range(cfg.n_layers):
        pre = f"blk.{i}."
        put(pre + "attn_norm.weight", lp["attn_norm_w"][i], norm)
        put(pre + "attn_q.weight", permute_to_interleaved(
            lp["wq"][i].T, cfg.n_heads), qtype)
        put(pre + "attn_k.weight", permute_to_interleaved(
            lp["wk"][i].T, cfg.n_kv_heads), qtype)
        put(pre + "attn_v.weight", lp["wv"][i].T, qtype)
        put(pre + "attn_output.weight", lp["wo"][i].T, qtype)
        put(pre + "ffn_norm.weight", lp["mlp_norm_w"][i], norm)
        put(pre + "ffn_gate.weight", lp["w_gate"][i].T, qtype)
        put(pre + "ffn_up.weight", lp["w_up"][i].T, qtype)
        put(pre + "ffn_down.weight", lp["w_down"][i].T, qtype)
    w.write()
    return path


GGUFS = {
    "jax_helper_f32_untied": None,
    "q4_0_untied": dict(qtype="q4_0", emb="q8_0"),
    "q4_0_tied_llama3": dict(qtype="q4_0", emb="q8_0", tied=True,
                             llama3=True),
    "q8_0_tied": dict(qtype="q8_0", emb="f16", tied=True),
    "f16_untied_f16_norms": dict(qtype="f16", emb="f16", norm_f16=True),
}


@pytest.fixture(scope="module")
def gguf_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("gguf")
    out = {}
    for i, (name, kw) in enumerate(GGUFS.items()):
        path = str(d / f"{name}.gguf")
        params = _tiny_params(10 + i)
        if kw is None:
            write_tiny_llama_gguf(path, JPRESETS["tiny"], params)
        else:
            write_port_gguf(path, params, **kw)
        out[name] = path
    return out


def _leaves(tree):
    return dict(JTC._flatten(tree))


def _bits(a):
    a = np.asarray(a)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.uint16)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def assert_same_tree(port, ref):
    p, r = _leaves(port), _leaves(ref)
    assert sorted(p) == sorted(r)
    for k in r:
        assert p[k].shape == r[k].shape, k
        np.testing.assert_array_equal(_bits(p[k]), _bits(r[k]), err_msg=k)


def assert_same_cfg(port_cfg, ref_cfg):
    assert dataclasses.asdict(port_cfg) == dataclasses.asdict(ref_cfg)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(GGUFS))
def test_load_model_matches_jax(gguf_files, name, dtype):
    path = gguf_files[name]
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    cfg, params, tok = TC.load_model(path, dtype=dtype)
    jcfg, jparams, jtok = JTC.load_model(path, dtype=jdt)
    assert_same_cfg(cfg, jcfg)
    assert tok == jtok
    assert_same_tree(params, jparams)
    want = np.float32 if dtype == "float32" else np.uint16
    assert all(v.dtype == want for v in _leaves(params).values())
    spec = GGUFS[name] or {}
    assert cfg.tie_embeddings == bool(spec.get("tied"))
    assert ("lm_head" in params) != bool(spec.get("tied"))
    assert (cfg.rope_freq_factors is not None) == bool(spec.get("llama3"))


def test_torch_dtype_names_the_same_cache():
    assert TC.dtype_name(torch.bfloat16) == "bfloat16"
    assert TC.dtype_name(np.float32) == TC.dtype_name("float32")
    with pytest.raises(ValueError):
        TC.dtype_name("int8")
    assert TC.cache_path("c", "abc", torch.float32) == os.path.join(
        "c", "abc.float32")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cache_roundtrip_and_shared_with_jax(tmp_path, gguf_files, dtype):
    """transcode_to_store → load_from_store gives load_params' tree, and
    the JAX package's cache of the same file holds the same files: one
    package reads the other's cache."""
    path = gguf_files["q4_0_tied_llama3"]
    jdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    with R.GGUFFile(path) as f:
        direct = TC.load_params(f, dtype=dtype)
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    TC.transcode_to_store(path, port_dir, dtype)
    JTC.transcode_to_store(path, jax_dir, jdt)
    cfg, params, tok = TC.load_from_store(port_dir)
    assert_same_tree(params, direct)
    for d in (port_dir, jax_dir):
        assert sorted(os.listdir(d)) == ["index.json", "weights.bin"]
    with open(os.path.join(port_dir, "index.json")) as f:
        pidx = json.load(f)
    with open(os.path.join(jax_dir, "index.json")) as f:
        jidx = json.load(f)
    assert pidx == jidx
    with open(os.path.join(port_dir, "weights.bin"), "rb") as f1, \
            open(os.path.join(jax_dir, "weights.bin"), "rb") as f2:
        assert f1.read() == f2.read()
    # each package reads the other's cache
    cfg2, from_jax, _ = TC.load_from_store(jax_dir)
    assert cfg2 == cfg
    assert_same_tree(from_jax, direct)
    jcfg, jparams, _ = JTC.load_from_store(port_dir)
    assert_same_cfg(cfg, jcfg)
    assert_same_tree(params, jparams)


def test_load_model_keys_cache_as_jax(tmp_path, gguf_files):
    """load_model caches at <cache>/<digest>.<dtype> as the JAX package
    does, and a second load comes from the cache (the GGUF gone)."""
    src = gguf_files["q8_0_tied"]
    path = str(tmp_path / "m.gguf")
    with open(src, "rb") as f, open(path, "wb") as g:
        g.write(f.read())
    cache = str(tmp_path / "cache")
    digest = TC.content_fingerprint(path)
    assert digest == JTC.content_fingerprint(path)
    cfg1, p1, _ = TC.load_model(path, cache_dir=cache, dtype="bfloat16")
    assert os.listdir(cache) == [f"{digest}.bfloat16"]
    os.remove(path)
    cfg2, p2, _ = TC.load_model(path, cache_dir=cache, dtype="bfloat16",
                                digest=digest)
    assert cfg1 == cfg2
    assert_same_tree(p2, p1)


def test_writer_writes_the_jax_bytes(tmp_path):
    rng = np.random.default_rng(SEED)
    a = rng.standard_normal((4, 64)).astype(np.float32)
    paths = []
    for mod in (W, JW):
        p = str(tmp_path / f"{mod.__name__.split('.')[0]}.gguf")
        w = mod.GGUFWriter(p)
        w.add_meta("general.architecture", "llama")
        w.add_meta("tokenizer.ggml.tokens", ["a", "bb", "ccc"])
        w.add_meta("tokenizer.ggml.scores", [0.5, -1.0, 2.0])
        w.add_meta("tokenizer.ggml.token_type", [1, 6, 3])
        w.add_meta("x.neg", -3)
        w.add_meta("x.flag", True)
        w.add_tensor_f32("a", a)
        w.add_tensor_f16("b", a[:1])
        w.add_tensor_raw("c", a.shape, R.GGML_Q4_0, mod.quantize_q4_0(a))
        w.add_tensor_raw("d", a.shape, R.GGML_Q8_0, mod.quantize_q8_0(a))
        w.write()
        paths.append(p)
    with open(paths[0], "rb") as f1, open(paths[1], "rb") as f2:
        assert f1.read() == f2.read()
    with R.GGUFFile(paths[0]) as f, JR.GGUFFile(paths[1]) as g:
        assert f.metadata == g.metadata
        assert {k: (t.ggml_type, t.ne, t.offset) for k, t in
                f.tensors.items()} == {k: (t.ggml_type, t.ne, t.offset)
                                       for k, t in g.tensors.items()}


# ---------------------------------------------------------------------------
# tokenizers from GGUF metadata
# ---------------------------------------------------------------------------

TEXTS = ["hello world", "  leading spaces and\ttabs\n", "naïve café 🙂",
         "<s>special</s> inside", "1234 + 5678 = 6912"]


def _spm_metadata():
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)]
    words = ["▁hello", "▁world", "▁lead", "ing", "▁sp", "aces", "▁and",
             "▁t", "abs", "▁na", "ï", "ve", "▁ca", "fé", "▁in", "side",
             "he", "ll", "lo", "wor", "ld", "▁", "▁1", "23", "4"]
    tokens = pieces + words
    types = [2, 3, 3] + [6] * 256 + [1] * len(words)
    scores = [0.0] * len(pieces) + [-float(i) for i in range(len(words))]
    return {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.scores": scores,
            "tokenizer.ggml.token_type": types,
            "tokenizer.ggml.bos_token_id": 1,
            "tokenizer.ggml.eos_token_id": 2}


def _bpe_metadata():
    from ollama_operator_tpu_torch.tokenizer.tokenizer import _BYTE_ENC
    byte_pieces = [_BYTE_ENC[b] for b in range(256)]
    merges = ["h e", "l l", "he ll", "hell o", "Ġ w", "o r", "Ġw or",
              "Ġwor l", "Ġworl d", "Ġ t", "a b", "Ġt ab", "1 2", "3 4"]
    tokens = byte_pieces + [m.replace(" ", "") for m in merges] + [
        "<|begin_of_text|>", "<|end_of_text|>"]
    n = len(tokens)
    return {"tokenizer.ggml.model": "gpt2",
            "tokenizer.ggml.tokens": tokens,
            "tokenizer.ggml.token_type": [1] * (n - 2) + [3, 3],
            "tokenizer.ggml.merges": merges,
            "tokenizer.ggml.bos_token_id": n - 2,
            "tokenizer.ggml.eos_token_id": n - 1}


@pytest.mark.parametrize("make_md", [_spm_metadata, _bpe_metadata],
                         ids=["llama", "gpt2"])
def test_tokenizer_from_gguf_metadata_matches_jax(tmp_path, make_md):
    """A vocabulary written into a GGUF and read back by the port's reader
    builds a port tokenizer that encodes and decodes as the JAX one."""
    md = make_md()
    path = str(tmp_path / "tok.gguf")
    params = _tiny_params(1)
    n = len(md["tokenizer.ggml.tokens"])
    params["tok_emb"] = np.zeros((n, params["tok_emb"].shape[1]),
                                 np.float32)
    params["lm_head"] = np.zeros((params["lm_head"].shape[0], n),
                                 np.float32)
    cfg = JPRESETS["tiny"]
    w = W.GGUFWriter(path)
    for k, v in (("general.architecture", "llama"),
                 ("llama.block_count", cfg.n_layers),
                 ("llama.embedding_length", cfg.dim),
                 ("llama.attention.head_count", cfg.n_heads),
                 ("llama.feed_forward_length", cfg.ffn_dim)):
        w.add_meta(k, v)
    for k, v in md.items():
        w.add_meta(k, v)
    w.add_tensor_f32("token_embd.weight", params["tok_emb"])
    w.write()
    with R.GGUFFile(path) as f:
        tok_md = {k: v for k, v in f.metadata.items()
                  if k.startswith("tokenizer.")}
    with JR.GGUFFile(path) as f:
        jtok_md = {k: v for k, v in f.metadata.items()
                   if k.startswith("tokenizer.")}
    assert tok_md == jtok_md
    tok = Tokenizer.from_gguf_metadata(tok_md)
    jtok = JTokenizer.from_gguf_metadata(jtok_md)
    assert (tok.model, tok.bos_id, tok.eos_id, tok.add_bos) == (
        jtok.model, jtok.bos_id, jtok.eos_id, jtok.add_bos)
    assert tok.eog_ids == jtok.eog_ids
    for text in TEXTS:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert len(ids) > 0
        assert tok.decode(ids) == jtok.decode(ids)
