"""A tiny llava served by the port against the JAX server, on the CPU.

``tests/fake_registry.py`` serves a tiny llama GGUF (a byte vocabulary
with a BOS token) with an mmproj projector layer (``TINY_VISION``, 4 image
tokens), and the same GGUF without one. Both packages' model managers
pull them into their own stores and load them in float32.

- greedy ``/api/generate`` with a PNG (square and not) and ``/api/chat``
  with images in two messages give the JAX server's tokens, text and
  ``prompt_eval_count``, which exceeds the text-only twin's by
  ``n_patches`` per image; ``/api/show`` lists ``vision`` for the llava
  model only;
- a text model answers images with the reference's 400, and an image
  that cannot be decoded is a 400 ("invalid image: ...");
- on a paged engine with the radix cache and on a dense one with parked
  slots, with pieces of 16 tokens, an image request is never parked,
  donated, stitched or chunked: two requests with equal prompts and
  different images give the JAX ``LoadedModel``'s streams, the second
  reusing nothing; a supervised restart classes it "multimodal".
"""

import base64
import dataclasses
import io
import json
import os
import urllib.error
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from fake_registry import FakeRegistry
from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models import vision as jvision
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.service import LoadedModel as JLoadedModel
from ollama_operator_tpu.server import app as japp
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models import vision as tvision
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime.engine import EngineConfig, SlotOptions
from ollama_operator_tpu_torch.runtime.scheduler import Request, Scheduler
from ollama_operator_tpu_torch.runtime.service import LoadedModel
from ollama_operator_tpu_torch.server import app as tapp
from ollama_operator_tpu_torch.tokenizer import Tokenizer
from test_torch_gguf import write_port_gguf
from test_torch_vision import jax_tree, write_mmproj

torch.set_num_threads(1)

VOCAB = dict(tokens=[f"<0x{i:02X}>" for i in range(256)],
             token_types=[6] * 256, bos_id=1, add_bos=True)
TOKENIZER_MD = {"tokenizer.ggml.model": "llama",
                "tokenizer.ggml.tokens": VOCAB["tokens"],
                "tokenizer.ggml.scores": [0.0] * 256,
                "tokenizer.ggml.token_type": VOCAB["token_types"],
                "tokenizer.ggml.bos_token_id": 1,
                "tokenizer.ggml.add_bos_token": True}
TPL = "{{ .Prompt }}"
GREEDY = {"temperature": 0, "num_predict": 6}
VCFG = dataclasses.replace(jvision.TINY_VISION, proj_dim=64)
N_PATCHES = VCFG.n_patches


def png_b64(h, w, seed):
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    Image.fromarray(rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                    "RGB").save(buf, "PNG")
    return base64.b64encode(buf.getvalue()).decode()


@pytest.fixture(scope="module")
def stack(tmp_path_factory):
    d = tmp_path_factory.mktemp("mm")
    tree = jax.tree_util.tree_map(np.asarray, jdec.init_params(
        JPRESETS["tiny"], jax.random.key(4), jnp.float32))
    gguf = open(write_port_gguf(str(d / "tiny.gguf"), tree,
                                tokenizer_md=TOKENIZER_MD), "rb").read()
    vtree = jax_tree(VCFG, 12)
    proj = open(write_mmproj(str(d / "mmproj.gguf"), VCFG, vtree),
                "rb").read()
    reg = FakeRegistry()
    reg.add_model("library", "tinyllava", "latest", gguf, template=TPL,
                  params={"temperature": 0}, projector_bytes=proj)
    reg.add_model("library", "tiny", "latest", gguf, template=TPL)
    host = reg.start().split("://", 1)[1]
    kw = dict(paged=False, max_slots=2, max_seq_len=128,
              min_prefill_bucket=16, decode_chunk=8)
    with mock.patch.dict(os.environ, {"TPU_WARM_BUCKETS": "0"}):
        port = tapp.ModelManager(str(d / "port"), cache_dir=str(d / "pc"),
                                 device="cpu", ecfg=EngineConfig(
                                     cache_dtype=torch.float32, **kw))
        jm = japp.ModelManager(str(d / "jax"), cache_dir=str(d / "jc"),
                               ecfg=JEngineConfig(cache_dtype=jnp.float32,
                                                  **kw))
        for name in ("tinyllava", "tiny"):
            port.pull(f"http://{host}/library/{name}")
            jm.client.pull(f"http://{host}/library/{name}")
        a, b = tapp.serve(port, "127.0.0.1", 0), japp.serve(
            jm, "127.0.0.1", 0)
        yield dict(host=host, ports=(a.server_address[1],
                                     b.server_address[1]),
                   tree=tree, vtree=vtree, port=port)
        for h in (a, b):
            h.shutdown()
        port.shutdown()
        jm.unload_now()
        jm.shutdown()
    reg.stop()


def _call(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def both(stack, path, body):
    return [_call(p, path, body) for p in stack["ports"]]


def _model(stack, name):
    return f"http://{stack['host']}/library/{name}"


def test_generate_with_images_matches_jax(stack):
    model = _model(stack, "tinyllava")
    text_only = {"model": model, "prompt": "what is this?", "stream": False,
                 "options": GREEDY}
    (s1, t), (s2, jt) = both(stack, "/api/generate", text_only)
    assert s1 == s2 == 200 and t["context"] == jt["context"]
    for imgs in ([png_b64(20, 12, 1)], [png_b64(16, 16, 2),
                                         png_b64(9, 30, 3)]):
        body = dict(text_only, images=imgs)
        (s1, out), (s2, jout) = both(stack, "/api/generate", body)
        assert s1 == s2 == 200, (out, jout)
        assert out["response"] == jout["response"]
        assert out["context"] == jout["context"]
        assert out["eval_count"] == jout["eval_count"] == 6
        assert out["prompt_eval_count"] == jout["prompt_eval_count"] == (
            t["prompt_eval_count"] + N_PATCHES * len(imgs))
        # the context holds the real ids only: the image was not kept
        assert out["context"][:len(t["context"]) - 6] == \
            t["context"][:len(t["context"]) - 6]


def test_chat_with_images_matches_jax(stack):
    body = {"model": _model(stack, "tinyllava"), "stream": False,
            "options": GREEDY, "messages": [
                {"role": "user", "content": "look", "images":
                 [png_b64(24, 10, 4)]},
                {"role": "assistant", "content": "ok"},
                {"role": "user", "content": "and this", "images":
                 [png_b64(8, 8, 5)]}]}
    (s1, out), (s2, jout) = both(stack, "/api/chat", body)
    assert s1 == s2 == 200, (out, jout)
    assert out["message"] == jout["message"]
    assert out["prompt_eval_count"] == jout["prompt_eval_count"]
    no_img = json.loads(json.dumps(body))
    for m in no_img["messages"]:
        m.pop("images", None)
    (_, twin), _ = both(stack, "/api/chat", no_img)
    assert out["prompt_eval_count"] == twin["prompt_eval_count"] + \
        2 * N_PATCHES


def test_show_lists_vision(stack):
    for name, want in (("tinyllava", True), ("tiny", False)):
        (s1, a), (s2, b) = both(stack, "/api/show",
                                {"model": _model(stack, name)})
        assert s1 == s2 == 200
        assert a["capabilities"] == b["capabilities"]
        assert ("vision" in a["capabilities"]) == want


def test_refusals_as_the_reference(stack):
    img = png_b64(8, 8, 6)
    body = {"model": _model(stack, "tiny"), "prompt": "hi", "stream": False,
            "images": [img], "options": GREEDY}
    (s1, a), (s2, b) = both(stack, "/api/generate", body)
    assert (s1, a) == (s2, b) == (400, {"error": (
        f"model {tapp.ModelName.parse(_model(stack, 'tiny')).short} has no "
        f"vision projector; it cannot accept images")})
    bad = dict(body, model=_model(stack, "tinyllava"),
               images=[base64.b64encode(b"\x89PNG\r\n\x1a\nxx").decode()])
    (s1, a), (s2, b) = both(stack, "/api/generate", bad)
    assert s1 == s2 == 400
    assert a["error"].startswith("invalid image: ")
    assert b["error"].startswith("invalid image: ")


@pytest.mark.parametrize("paged", [True, False])
def test_image_requests_never_reuse_or_chunk(stack, paged, monkeypatch):
    monkeypatch.setenv("TPU_PREFILL_CHUNK", "16")
    monkeypatch.setenv("TPU_MIN_PREFIX_REUSE", "4")
    monkeypatch.setenv("TPU_WARM_BUCKETS", "0")
    tcfg, jcfg = TPRESETS["tiny"], dataclasses.replace(
        JPRESETS["tiny"], kernels="interpret")
    kw = dict(paged=paged, page_size=16, max_slots=2, max_seq_len=128,
              min_prefill_bucket=16, decode_chunk=8)
    tv = (dataclasses.replace(tvision.TINY_VISION, proj_dim=64),
          params_from_numpy(stack["vtree"], "cpu"))
    lm = LoadedModel("tinyllava", tcfg, params_from_numpy(stack["tree"],
                                                          "cpu"),
                     Tokenizer(model="llama", **VOCAB), template=TPL,
                     device="cpu", vision=tv, ecfg=EngineConfig(
                         cache_dtype=torch.float32, **kw))
    jlm = JLoadedModel("tinyllava", jcfg, jax.tree_util.tree_map(
        jnp.asarray, stack["tree"]), JTokenizer(model="llama", **VOCAB),
        template=TPL, vision=(VCFG, jax.tree_util.tree_map(
            jnp.asarray, stack["vtree"])),
        ecfg=JEngineConfig(cache_dtype=jnp.float32, **kw))
    prompt = "a prompt long enough to take more than one piece of sixteen"
    try:
        rng = np.random.default_rng(9)
        outs = []
        for i in range(2):
            img = rng.integers(0, 256, (12 + i, 10, 3)).astype(np.uint8)
            got = lm.generate_stream(prompt, GREEDY, images=[img])
            want = jlm.generate_stream(prompt, GREEDY, images=[img])
            res = [f for _, f in got][-1]
            jres = [f for _, f in want][-1]
            assert res.context == jres.context
            assert res.prompt_tokens == jres.prompt_tokens > 16
            assert res.reused_tokens == 0
            outs.append(res.context)
        assert lm.scheduler.n_prefill_pieces == 0
        assert lm.engine.radix_pages == 0
        assert not lm.scheduler._parked
        # a text request of the same prompt is chunked and kept
        res = lm.generate(prompt, GREEDY)
        assert lm.scheduler.n_prefill_pieces > 0
        assert (lm.engine.radix_pages > 0) if paged else lm.scheduler._parked
        assert res.context[:-6] == outs[0][:-6]
    finally:
        lm.unload()
        jlm.unload()
    req = Request([1, 256, 256, 5], SlotOptions(temperature=0), 4,
                  frozenset(), embeds=torch.zeros(4, 64))
    assert Scheduler._replay_ineligible(req) == "multimodal"
