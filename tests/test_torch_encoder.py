"""The port's BERT encoder (``models/encoder.py``), its GGUF mapping and
its WordPiece tokenizer against the JAX package's, on the CPU.

A tiny encoder (2 layers, dim 64, 4 heads, ffn 128, 64 positions) with
every bias and norm drawn at random, so each leaf moves the output:

- ``forward`` on a padded batch of mixed valid lengths, mean and cls
  pooling, f32 on both sides: within 1e-5 (the same f32 products and
  sums, reassociated);
- ``encoder_config_from_gguf`` and ``load_encoder_params`` on a GGUF the
  test writes (f32 and f16 tensors): the same config and the same bits;
  a pooling type other than 1 or 2 is refused by both;
- WordPiece ids of a ``bert`` GGUF's metadata, [CLS] ... [SEP] framed:
  equal to the JAX tokenizer's;
- ``EmbeddingModel.embed`` against the JAX one on texts that pad to
  several lengths, one past the position table (cut at T in both);
- ``init_params`` makes the JAX leaves at their shapes; it and
  ``EmbeddingModel`` default to the card and raise without CUDA.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.gguf import transcode as jtr
from ollama_operator_tpu.gguf.reader import GGUFFile as JGGUFFile
from ollama_operator_tpu.models import encoder as jenc
from ollama_operator_tpu.runtime.service import \
    EmbeddingModel as JEmbeddingModel
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.gguf import transcode as ttr
from ollama_operator_tpu_torch.gguf.reader import GGUFFile
from ollama_operator_tpu_torch.gguf.writer import GGUFWriter
from ollama_operator_tpu_torch.models import encoder as tenc
from ollama_operator_tpu_torch.runtime.service import EmbeddingModel
from ollama_operator_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
VOCAB = (["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
         + ["the", "sky", "is", "blue", "why", "un", "##believ", "##able",
            "##s", "##ing", "##ed", "hello", "world", ",", ".", "!", "a",
            "b", "c", "embed", "me", "please", "vector", "search"]
         + [f"w{i}" for i in range(34)])          # 64 pieces
TOKENIZER_MD = {"tokenizer.ggml.model": "bert",
                "tokenizer.ggml.tokens": VOCAB,
                "tokenizer.ggml.token_type": [1] * len(VOCAB),
                "tokenizer.ggml.cls_token_id": 2,
                "tokenizer.ggml.seperator_token_id": 3,
                "tokenizer.ggml.unknown_token_id": 1}
TEXTS = ["the sky is blue", "Why is the sky blue!", "unbelievable skies",
         "hello, world.", "zzz the qqq", "embed me please", "",
         " ".join(["vector search"] * 40)]       # 82 tokens: past the table


def config(pooling="mean"):
    return jenc.EncoderConfig(vocab_size=len(VOCAB), dim=64, n_layers=2,
                              n_heads=4, ffn_dim=128, max_seq_len=64,
                              pooling=pooling)


def port_config(jc):
    return tenc.EncoderConfig(**dataclasses.asdict(jc))


def numpy_tree(cfg, seed=3):
    """The JAX init's tree with every bias, norm and the token-type table
    drawn at random."""
    p = jax.tree_util.tree_map(np.asarray, jenc.init_params(
        cfg, jax.random.key(seed)))
    rng = np.random.default_rng(seed)

    def move(tree):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = move(v)
            elif k.startswith("b") or "norm" in k or k == "type_emb":
                base = 1.0 if k.endswith("norm_w") else 0.0
                out[k] = (base + rng.normal(0.0, 0.1, v.shape)
                          ).astype(np.float32)
            else:
                out[k] = v
        return out
    return move(p)


def write_bert_gguf(path, cfg, tree, pooling=1, f16=False):
    """``tree`` (the encoder's [in, out] layout) as a llama.cpp BERT GGUF
    ([out, in] weights)."""
    w = GGUFWriter(path)
    w.add_meta("general.architecture", "bert")
    for k, v in (("block_count", cfg.n_layers),
                 ("embedding_length", cfg.dim),
                 ("attention.head_count", cfg.n_heads),
                 ("feed_forward_length", cfg.ffn_dim),
                 ("context_length", cfg.max_seq_len),
                 ("attention.layer_norm_epsilon", 1e-12),
                 ("pooling_type", pooling)):
        w.add_meta(f"bert.{k}", v)
    for k, v in TOKENIZER_MD.items():
        w.add_meta(k, v)
    put = w.add_tensor_f16 if f16 else w.add_tensor_f32
    for name, key in (("token_embd.weight", "tok_emb"),
                      ("position_embd.weight", "pos_emb"),
                      ("token_types.weight", "type_emb")):
        put(name, tree[key])
    w.add_tensor_f32("token_embd_norm.weight", tree["emb_norm_w"])
    w.add_tensor_f32("token_embd_norm.bias", tree["emb_norm_b"])
    lay = tree["layers"]
    for i in range(cfg.n_layers):
        for gguf, key in (("attn_q", "q"), ("attn_k", "k"), ("attn_v", "v"),
                          ("attn_output", "o")):
            put(f"blk.{i}.{gguf}.weight", np.ascontiguousarray(
                lay[f"w{key}"][i].T))
            w.add_tensor_f32(f"blk.{i}.{gguf}.bias", lay[f"b{key}"][i])
        put(f"blk.{i}.ffn_up.weight", np.ascontiguousarray(lay["w_up"][i].T))
        w.add_tensor_f32(f"blk.{i}.ffn_up.bias", lay["b_up"][i])
        put(f"blk.{i}.ffn_down.weight",
            np.ascontiguousarray(lay["w_down"][i].T))
        w.add_tensor_f32(f"blk.{i}.ffn_down.bias", lay["b_down"][i])
        for gguf, key in (("attn_output_norm", "attn_norm"),
                          ("layer_output_norm", "ffn_norm")):
            w.add_tensor_f32(f"blk.{i}.{gguf}.weight", lay[f"{key}_w"][i])
            w.add_tensor_f32(f"blk.{i}.{gguf}.bias", lay[f"{key}_b"][i])
    w.write()
    return path


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_forward_matches_jax(pooling):
    jc = config(pooling)
    tree = numpy_tree(jc)
    rng = np.random.default_rng(7)
    toks = rng.integers(5, len(VOCAB), (4, 32)).astype(np.int32)
    lens = np.array([32, 1, 17, 0], np.int32)
    toks[np.arange(32)[None, :] >= lens[:, None]] = 0
    want = jenc.forward(jax.tree_util.tree_map(jnp.asarray, tree), jc,
                        jnp.asarray(toks), jnp.asarray(lens))
    got = tenc.forward(params_from_numpy(tree, "cpu"), port_config(jc),
                       torch.from_numpy(toks), torch.from_numpy(lens))
    assert got.dtype == torch.float32 and got.shape == (4, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # a valid row does not depend on its padding
    toks2 = toks.copy()
    toks2[2, 17:] = 9
    again = tenc.forward(params_from_numpy(tree, "cpu"), port_config(jc),
                         torch.from_numpy(toks2), torch.from_numpy(lens))
    np.testing.assert_allclose(again[2].numpy(), got[2].numpy(), **TOL)


@pytest.mark.parametrize("f16,pooling", [(False, 1), (True, 2)])
def test_gguf_config_and_params_match_jax(tmp_path, f16, pooling):
    jc = config()
    path = write_bert_gguf(str(tmp_path / "bert.gguf"), jc, numpy_tree(jc),
                           pooling=pooling, f16=f16)
    with JGGUFFile(path) as jf:
        jcfg = jtr.encoder_config_from_gguf(jf)
        jp = jtr.load_encoder_params(jf, jcfg)
    with GGUFFile(path) as f:
        tcfg = ttr.encoder_config_from_gguf(f)
        tp = ttr.load_encoder_params(f, tcfg)
        assert ttr.is_encoder_arch(f.arch)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.pooling == ("cls" if pooling == 2 else "mean")
    flat = lambda t: {k: v for k, v in  # noqa: E731
                      jax.tree_util.tree_leaves_with_path(t)}
    a, b = flat(tp), flat(jp)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype == np.float32
        np.testing.assert_array_equal(a[k], b[k])


def test_pooling_type_refused_as_jax(tmp_path):
    jc = config()
    path = write_bert_gguf(str(tmp_path / "bert.gguf"), jc, numpy_tree(jc),
                           pooling=3)
    with JGGUFFile(path) as jf, pytest.raises(NotImplementedError) as je:
        jtr.encoder_config_from_gguf(jf)
    with GGUFFile(path) as f, pytest.raises(NotImplementedError) as te:
        ttr.encoder_config_from_gguf(f)
    assert str(te.value) == str(je.value)


def test_wordpiece_ids_match_jax():
    tok = Tokenizer.from_gguf_metadata(TOKENIZER_MD)
    jtok = JTokenizer.from_gguf_metadata(TOKENIZER_MD)
    for text in TEXTS + ["skying skied, w3!", "The Sky IS Blue"]:
        ids = tok.encode(text)
        assert ids == jtok.encode(text), text
        assert ids[0] == 2 and ids[-1] == 3      # [CLS] ... [SEP]


@pytest.mark.parametrize("pooling", ["mean", "cls"])
def test_embedding_model_matches_jax(pooling):
    jc = config(pooling)
    tree = numpy_tree(jc, seed=5)
    jm = JEmbeddingModel("mini", jc, tree,
                         JTokenizer.from_gguf_metadata(TOKENIZER_MD))
    tm = EmbeddingModel("mini", port_config(jc),
                        params_from_numpy(tree, "cpu"),
                        Tokenizer.from_gguf_metadata(TOKENIZER_MD),
                        device="cpu")
    assert tm.serving_dtype == "float32" and tm.scheduler.n_active == 0
    for texts in (TEXTS, TEXTS[:3], [TEXTS[-1]]):
        want = jm.embed(texts)
        got = tm.embed(texts)
        assert got.dtype == np.float32 and got.shape == want.shape
        np.testing.assert_allclose(got, want, **TOL)
    with pytest.raises(Exception, match="embedding model"):
        tm.generate_stream("hi")


def test_init_params_makes_the_jax_leaves():
    jc = config()
    jp = jax.tree_util.tree_map(np.asarray, jenc.init_params(
        jc, jax.random.key(0)))
    tp = tenc.init_params(port_config(jc), torch.Generator().manual_seed(0),
                          device="cpu")
    shapes = lambda t: {jax.tree_util.keystr(k): tuple(v.shape)  # noqa
                        for k, v in jax.tree_util.tree_leaves_with_path(t)}
    assert shapes(tp) == shapes(jp)
    assert port_config(jc).n_params == jc.n_params


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_config(config())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tenc.init_params(cfg, torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        EmbeddingModel("mini", cfg, {}, Tokenizer.from_gguf_metadata(
            TOKENIZER_MD))
