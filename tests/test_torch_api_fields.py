"""The /api/generate fields ``images``, ``format``, ``suffix`` and
``keep_alive`` on the port's HTTP server, held to the reference's rules on
the CPU at the tiny preset.

- ``images``: every model of the port is text-only, so any image is a 400
  with the message the reference's ``LoadedModel.generate_stream`` gives a
  model without a vision projector;
- ``format``: None and "" ask for free text; "json" and a schema dict ask
  for constrained decoding, which the port refuses with a 400 until
  grammars are ported; any other value is the reference's 400;
- ``suffix``: rendered through the template's ``.Suffix`` exactly as the
  reference's ``LoadedModel.render_prompt`` renders it, or the reference's
  400 when the template has none;
- ``keep_alive``: parsed as the reference's ``parse_keep_alive`` parses it
  (a bad value is a 400); an empty prompt with keep_alive 0 unloads the
  model and answers ``done_reason: "unload"``.

The reference's rules are called on the same request: its
``parse_keep_alive``, and its ``LoadedModel`` methods on a stand-in that
holds only what they read before the rule fires (its template, name,
tokenizer, options and context length), so no JAX engine is built.
"""

from __future__ import annotations

import json
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from ollama_operator_tpu.runtime.errors import BadRequest as JBadRequest
from ollama_operator_tpu.runtime.service import LoadedModel as JLoadedModel
from ollama_operator_tpu.server.app import \
    parse_keep_alive as jparse_keep_alive
from ollama_operator_tpu.server.template import Template as JTemplate
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.models import decoder
from ollama_operator_tpu_torch.models.config import PRESETS
from ollama_operator_tpu_torch.runtime.engine import EngineConfig
from ollama_operator_tpu_torch.runtime.service import BadRequest, LoadedModel
from ollama_operator_tpu_torch.server.app import (ModelManager,
                                                  parse_keep_alive, serve)
from ollama_operator_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

BYTES = dict(tokens=[f"<0x{i:02X}>" for i in range(256)],
             token_types=[6] * 256)
TPL = "{{ .Prompt }}"
FIM = "<PRE>{{ .Prompt }}<SUF>{{ .Suffix }}<MID>"
FEW = {"temperature": 0, "num_predict": 2}


def _model(name, template):
    cfg = PRESETS["tiny"]
    params = decoder.init_params(cfg, torch.Generator().manual_seed(0),
                                 torch.float32, "cpu")
    return LoadedModel(name, cfg, params, Tokenizer(model="llama", **BYTES),
                       template=template, device="cpu",
                       ecfg=EngineConfig(paged=True, max_slots=2,
                                         max_seq_len=64,
                                         cache_dtype=torch.float32,
                                         page_size=16, min_prefill_bucket=16,
                                         decode_chunk=2))


@pytest.fixture(scope="module")
def server():
    mm = ModelManager(device="cpu")
    mm.add(_model("tiny", TPL))
    mm.add(_model("fim", FIM))
    httpd = serve(mm, "127.0.0.1", 0)
    try:
        yield mm, httpd.server_address[1]
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()


def _post(port, body):
    """(status, final JSON object) of a non-streamed /api/generate."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/generate",
        data=json.dumps(dict(body, stream=False)).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _reference(template):
    """The reference's LoadedModel as its render_prompt and
    generate_stream read it up to their field rules."""
    return types.SimpleNamespace(
        name="tiny", template=JTemplate(template), system=None,
        default_params={}, vision=None,
        tokenizer=JTokenizer(model="llama", **BYTES),
        engine=types.SimpleNamespace(max_seq=64))


def _reference_error(fn, *args, **kw) -> str:
    with pytest.raises(JBadRequest) as e:
        fn(_reference(TPL), *args, **kw)
    return str(e.value)


def test_images_refused_as_the_reference(server):
    _, port = server
    want = _reference_error(JLoadedModel.generate_stream, "hi",
                            images=[np.zeros((2, 2, 3), np.uint8)])
    status, out = _post(port, {"model": "tiny", "prompt": "hi",
                               "images": ["aGVsbG8="], "options": FEW})
    assert (status, out["error"]) == (400, want)
    assert "no vision projector" in want


def test_format_other_values_refused_as_the_reference(server):
    _, port = server
    want = _reference_error(JLoadedModel.generate_stream, "hi",
                            format="yaml")
    status, out = _post(port, {"model": "tiny", "prompt": "hi",
                               "format": "yaml", "options": FEW})
    assert (status, out["error"]) == (400, want)


@pytest.mark.parametrize("fmt", ["json", {"type": "object"}])
def test_format_json_refused_until_grammars_are_ported(server, fmt):
    """The reference constrains the output for these; the port cannot yet,
    so it refuses rather than answer free text with 200."""
    _, port = server
    status, out = _post(port, {"model": "tiny", "prompt": "hi",
                               "format": fmt, "options": FEW})
    assert status == 400
    assert "constrained decoding" in out["error"]
    assert "not ported" in out["error"]


@pytest.mark.parametrize("fmt", [None, ""])
def test_format_empty_is_free_text(server, fmt):
    _, port = server
    status, out = _post(port, {"model": "tiny", "prompt": "hi",
                               "format": fmt, "options": FEW})
    assert status == 200 and out["done"] and out["eval_count"] == 2


def test_suffix_renders_as_the_reference(server):
    mm, port = server
    lm = mm.require_loaded("fim")
    ref = JLoadedModel.render_prompt(_reference(FIM), "def f(",
                                     suffix="return x")
    assert lm.render_prompt("def f(", suffix="return x") == ref
    assert ref == "<PRE>def f(<SUF>return x<MID>"
    status, out = _post(port, {"model": "fim", "prompt": "def f(",
                               "suffix": "return x", "options": FEW})
    assert status == 200 and out["done"]
    # the prompt went through the template's suffix section
    assert out["prompt_eval_count"] == len(lm.tokenizer.encode(
        ref, add_bos=lm.tokenizer.add_bos))


def test_suffix_without_template_section_refused_as_the_reference(server):
    _, port = server
    want = _reference_error(JLoadedModel.render_prompt, "def f(",
                            suffix="return x")
    status, out = _post(port, {"model": "tiny", "prompt": "def f(",
                               "suffix": "return x", "options": FEW})
    assert (status, out["error"]) == (400, want)
    assert _post(port, {"model": "tiny", "prompt": "def f(", "raw": True,
                        "suffix": "return x", "options": FEW})[0] == 200


KEEP_ALIVE = [0, -1, 300, 1.5, "5m", "1h30m", "300ms", "-1", "0", "2.5s",
              "", "five", "5 minutes", "1d", True, float("nan")]


@pytest.mark.parametrize("value", KEEP_ALIVE)
def test_parse_keep_alive_matches_the_reference(value):
    try:
        want = jparse_keep_alive(value)
    except JBadRequest as e:
        with pytest.raises(BadRequest) as got:
            parse_keep_alive(value)
        assert str(got.value) == str(e)
    else:
        assert parse_keep_alive(value) == want


@pytest.mark.parametrize("value", ["five", True, "", "1d"])
def test_bad_keep_alive_is_a_400(server, value):
    _, port = server
    with pytest.raises(JBadRequest) as e:
        jparse_keep_alive(value)
    status, out = _post(port, {"model": "tiny", "prompt": "hi",
                               "keep_alive": value, "options": FEW})
    assert (status, out["error"]) == (400, f"invalid keep_alive {value!r}")
    status, out = _post(port, {"model": "tiny", "keep_alive": value})
    assert (status, out["error"]) == (400, str(e.value))


def test_valid_keep_alive_is_accepted(server):
    _, port = server
    status, out = _post(port, {"model": "tiny", "prompt": "hi",
                               "keep_alive": "5m", "options": FEW})
    assert status == 200 and out["eval_count"] == 2
    status, out = _post(port, {"model": "tiny", "keep_alive": -1})
    assert (status, out["done_reason"]) == (200, "load")


def test_keep_alive_zero_with_empty_prompt_unloads():
    mm = ModelManager(device="cpu")
    lm = mm.add(_model("tiny", TPL))
    httpd = serve(mm, "127.0.0.1", 0)
    port = httpd.server_address[1]
    try:
        status, out = _post(port, {"model": "tiny", "keep_alive": 0})
        assert (status, out["done"], out["done_reason"]) == (200, True,
                                                             "unload")
        assert mm.list_models() == []
        assert lm.scheduler._stop            # its scheduler was shut down
        status, _ = _post(port, {"model": "tiny", "prompt": "hi"})
        assert status == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()
