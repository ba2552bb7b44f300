"""The port's llava pieces against the JAX package, on the CPU:

- ``models/vision.encode`` against the JAX ``encode`` at ``TINY_VISION``,
  with the penultimate-layer (-2) and the every-layer (-1) selections,
  f32 weights, relative tolerance 1e-5;
- the same with bf16 weights (the card's tower), against the JAX
  function the serving path calls (``jax.jit`` of ``encode`` on the bf16
  tree): both keep f32 activations, so they agree as closely;
- ``gguf/transcode.load_vision_params`` against the JAX loader on an
  mmproj written here, in both ffn conventions, in f32 and bf16;
- ``decoder.prefill_chunk`` from ``inputs_embeds`` against the JAX one,
  with pad ids in the tokens (never looked up);
- ``Engine.admit(embeds=...)`` of the prompt's own token embeddings gives
  ``admit(ids)``'s stream on the paged pool and on the dense cache, and
  an admission with image embeddings (pad ids at their positions) gives
  the JAX engine's greedy stream.
"""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ollama_operator_tpu.gguf import transcode as jtc
from ollama_operator_tpu.gguf.reader import GGUFFile as JGGUFFile
from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models import vision as jvision
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.runtime.engine import Engine as JEngine
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import SlotOptions as JSlotOptions
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.gguf import transcode as ttc
from ollama_operator_tpu_torch.gguf.reader import GGUFFile
from ollama_operator_tpu_torch.gguf.writer import GGUFWriter
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models import vision as tvision
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)

torch.set_num_threads(1)


def jax_tree(cfg, seed, dtype=jnp.float32):
    """The JAX tower's weights with nonzero biases and norm weights (its
    init leaves them 0 and 1), as numpy."""
    p = jax.tree_util.tree_map(np.asarray, jvision.init_params(
        cfg, jax.random.key(seed), jnp.float32))
    rng = np.random.default_rng(seed)

    def jitter(tree):
        for k, v in tree.items():
            if isinstance(v, dict):
                jitter(v)
            elif k.endswith("_b") or k.startswith("b"):
                tree[k] = (rng.standard_normal(v.shape) * 0.05
                           ).astype(np.float32)
            elif k.endswith("_w"):
                tree[k] = (1 + rng.standard_normal(v.shape) * 0.1
                           ).astype(np.float32)
    jitter(p)
    return jax.tree_util.tree_map(lambda a: a.astype(dtype), p)


def images(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, cfg.image_size, cfg.image_size, 3)
                               ).astype(np.float32)


@pytest.mark.parametrize("select", [-2, -1])
def test_encode_matches_jax(select):
    jcfg = dataclasses.replace(jvision.TINY_VISION, select_layer=select)
    tcfg = dataclasses.replace(tvision.TINY_VISION, select_layer=select)
    tree = jax_tree(jcfg, 1)
    x = images(jcfg, 2, 2)
    j = np.asarray(jvision.encode(jcfg, jax.tree_util.tree_map(
        jnp.asarray, tree), jnp.asarray(x)))
    t = tvision.encode(tcfg, params_from_numpy(tree, "cpu"),
                       torch.from_numpy(x))
    assert t.shape == (2, tcfg.n_patches, tcfg.proj_dim)
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                               atol=1e-5 * np.abs(j).max())
    assert tcfg.n_run == (2 if select == -2 else 3)


def test_encode_bf16_weights_match_the_jax_serving_function():
    cfg = jvision.TINY_VISION
    tree = jax_tree(cfg, 3, ml_dtypes.bfloat16)
    x = images(cfg, 3, 4)
    fn = jax.jit(lambda p, im: jvision.encode(cfg, p, im))
    j = np.asarray(fn(jax.tree_util.tree_map(jnp.asarray, tree),
                      jnp.asarray(x)))
    assert j.dtype == np.float32
    tp = params_from_numpy(tree, "cpu")
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    t = tvision.encode(tvision.TINY_VISION, tp, torch.from_numpy(x))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=1e-5,
                               atol=1e-5 * np.abs(j).max())


def test_init_params_makes_the_jax_leaves():
    cfg = tvision.TINY_VISION
    t = tvision.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    j = jvision.init_params(jvision.TINY_VISION, jax.random.key(0))
    flat = dict(jax.tree_util.tree_flatten_with_path(j)[0])
    tflat = {k: v for k, v in jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(lambda a: a.numpy(), t))[0]}
    assert {jax.tree_util.keystr(k): v.shape for k, v in flat.items()} == \
        {jax.tree_util.keystr(k): v.shape for k, v in tflat.items()}
    assert cfg.n_params == sum(v.size for v in tflat.values())


def write_mmproj(path, cfg, tree, swapped=False, f16=False):
    """A llama.cpp clip mmproj GGUF of ``tree``; ``swapped`` writes the
    convention whose ``ffn_up`` holds the F→W projection."""
    w = GGUFWriter(path)
    add = w.add_tensor_f16 if f16 else w.add_tensor_f32

    def put(name, a):
        add(name, np.ascontiguousarray(np.asarray(a, np.float32)))
    w.add_meta("general.architecture", "clip")
    w.add_meta("clip.vision.image_size", cfg.image_size)
    w.add_meta("clip.vision.patch_size", cfg.patch_size)
    w.add_meta("clip.vision.embedding_length", cfg.width)
    w.add_meta("clip.vision.feed_forward_length", cfg.ffn_dim)
    w.add_meta("clip.vision.block_count", cfg.n_layers)
    w.add_meta("clip.vision.attention.head_count", cfg.n_heads)
    w.add_meta("clip.vision.attention.layer_norm_epsilon", cfg.norm_eps)
    P = cfg.patch_size
    put("v.patch_embd.weight",
        np.asarray(tree["patch_emb"]).T.reshape(cfg.width, 3, P, P))
    put("v.class_embd", tree["class_emb"])
    put("v.position_embd.weight", tree["pos_emb"])
    put("v.pre_ln.weight", tree["pre_ln_w"])
    put("v.pre_ln.bias", tree["pre_ln_b"])
    put("mm.0.weight", np.asarray(tree["mm_0"]).T)
    put("mm.0.bias", tree["mm_0_b"])
    put("mm.2.weight", np.asarray(tree["mm_2"]).T)
    put("mm.2.bias", tree["mm_2_b"])
    lp = tree["layers"]
    up, down = ("ffn_down", "ffn_up") if swapped else ("ffn_up", "ffn_down")
    for i in range(cfg.n_layers):
        pre = f"v.blk.{i}."
        for nm in ("ln1", "ln2"):
            put(pre + nm + ".weight", lp[nm + "_w"][i])
            put(pre + nm + ".bias", lp[nm + "_b"][i])
        for nm, key in (("attn_q", "q"), ("attn_k", "k"), ("attn_v", "v"),
                        ("attn_out", "o")):
            put(pre + nm + ".weight", np.asarray(lp["w" + key][i]).T)
            put(pre + nm + ".bias", lp["b" + key][i])
        put(pre + up + ".weight", np.asarray(lp["w_up"][i]).T)
        put(pre + up + ".bias", lp["b_up"][i])
        put(pre + down + ".weight", np.asarray(lp["w_down"][i]).T)
        put(pre + down + ".bias", lp["b_down"][i])
    w.write()
    return path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swapped", [False, True])
def test_load_vision_params_matches_jax(tmp_path, swapped, dtype):
    cfg = dataclasses.replace(jvision.TINY_VISION, proj_dim=48)
    tree = jax_tree(cfg, 5)
    path = write_mmproj(str(tmp_path / "mmproj.gguf"), cfg, tree, swapped,
                        f16=dtype == "bfloat16")
    with JGGUFFile(path) as f:
        jcfg = jtc.vision_config_from_gguf(f)
        jp = jtc.load_vision_params(f, jcfg, dtype=getattr(
            ml_dtypes, dtype) if dtype == "bfloat16" else np.float32)
    with GGUFFile(path) as f:
        tcfg = ttc.vision_config_from_gguf(f)
        tp = ttc.load_vision_params(f, tcfg, dtype=dtype)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    assert tcfg.select_layer == -1 and tcfg.proj_dim == 48
    jflat = jax.tree_util.tree_flatten_with_path(jp)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tp)[0])
    assert len(jflat) == len(tflat)
    for k, v in jflat:
        got = tflat[k]
        want = (np.asarray(v).view(np.uint16) if dtype == "bfloat16"
                else np.asarray(v))
        assert got.dtype == want.dtype, k
        np.testing.assert_array_equal(got, want, err_msg=str(k))
    # the loaded tower encodes as the written one (all file layers)
    x = images(cfg, 1, 6)
    ref = jvision.encode(dataclasses.replace(cfg, select_layer=-1),
                         jax.tree_util.tree_map(jnp.asarray, tree),
                         jnp.asarray(x))
    got = tvision.encode(tcfg, params_from_numpy(tp, "cpu"),
                         torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-5,
                               atol=2e-2 * float(np.abs(ref).max()))


@pytest.fixture(scope="module")
def llm():
    jcfg = dataclasses.replace(JPRESETS["tiny"], kernels="interpret")
    tree = jax.tree_util.tree_map(np.asarray, jdec.init_params(
        jcfg, jax.random.key(7), jnp.float32))
    return jcfg, TPRESETS["tiny"], tree


def test_prefill_from_inputs_embeds_matches_jax(llm):
    jcfg, tcfg, tree = llm
    rng = np.random.default_rng(8)
    tokens = rng.integers(0, tcfg.vocab_size, (2, 16))
    tokens[:, 3:9] = tcfg.vocab_size        # image positions: the pad id
    emb = (rng.standard_normal((2, 16, tcfg.dim)) * 0.05).astype(np.float32)
    jl, jk, jv = jdec.prefill_chunk(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg,
        jnp.asarray(tokens, jnp.int32), inputs_embeds=jnp.asarray(emb))
    params = params_from_numpy(tree, "cpu")
    tl, tk, tv = tdec.prefill_chunk(params, tcfg, torch.from_numpy(tokens),
                                    inputs_embeds=torch.from_numpy(emb))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk), rtol=1e-5,
                               atol=1e-6)
    # without embeds, the lookup of the same (real) ids
    real = np.where(tokens == tcfg.vocab_size, 1, tokens)
    a, _, _ = tdec.prefill_chunk(params, tcfg, torch.from_numpy(real))
    b, _, _ = tdec.prefill_chunk(params, tcfg, torch.from_numpy(real),
                                 inputs_embeds=params["tok_emb"][
                                     torch.from_numpy(real)])
    np.testing.assert_array_equal(a.numpy(), b.numpy())


ECFG = dict(max_slots=2, max_seq_len=64, min_prefill_bucket=16,
            decode_chunk=4)


def _stream(eng, prompt, opts, **kw):
    out = [eng.admit(0, prompt, opts, **kw)]
    for _ in range(2):
        out += [int(t[0]) for t in eng.decode_n_launch(4).wait()]
    eng.release(0)
    return out


@pytest.mark.parametrize("paged", [True, False])
def test_admit_embeds_of_token_embeddings_equals_admit_ids(llm, paged):
    _, tcfg, tree = llm
    params = params_from_numpy(tree, "cpu")
    eng = Engine(tcfg, params, EngineConfig(
        paged=paged, page_size=16, cache_dtype=torch.float32, **ECFG),
        device="cpu")
    prompt = np.random.default_rng(9).integers(1, tcfg.vocab_size, 11)
    opts = SlotOptions(temperature=0.0)
    a = _stream(eng, prompt, opts)
    emb = tree["tok_emb"][prompt]
    b = _stream(eng, prompt, opts, embeds=emb)
    assert a == b


@pytest.mark.parametrize("paged", [True, False])
def test_admit_image_embeds_matches_jax(llm, paged):
    jcfg, tcfg, tree = llm
    rng = np.random.default_rng(10)
    V = tcfg.vocab_size
    prompt = rng.integers(1, V, 14)
    prompt[1:7] = V                          # six image tokens after BOS
    emb = tree["tok_emb"][np.where(prompt == V, 0, prompt)].copy()
    emb[1:7] = rng.standard_normal((6, tcfg.dim)).astype(np.float32) * 0.05
    opts = dict(temperature=0.0, repeat_penalty=1.3)
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                   ecfg=JEngineConfig(paged=paged, page_size=16,
                                      cache_dtype=jnp.float32, **ECFG))
    want = [jeng.admit(0, prompt.astype(np.int32), JSlotOptions(**opts),
                       embeds=emb)]
    want += [int(t[0]) for t in jeng.decode_n(4)]
    want += [int(t[0]) for t in jeng.decode_n(4)]
    teng = Engine(tcfg, params_from_numpy(tree, "cpu"), EngineConfig(
        paged=paged, page_size=16, cache_dtype=torch.float32, **ECFG),
        device="cpu")
    got = [teng.admit(0, prompt, SlotOptions(**opts), embeds=emb)]
    # the penalty window counts the real ids and the first token; the
    # pad ids land in the sentinel column
    assert int(teng.counts[0, :V].sum()) == int((prompt != V).sum()) + 1
    for _ in range(2):
        got += [int(t[0]) for t in teng.decode_n_launch(4).wait()]
    assert got == want
