"""The chat surface of the port's HTTP server held against the JAX
package's server, on the CPU at the tiny preset, on the same weights and a
template with ``.Messages`` and ``.Tools``.

Routes: ``/api/chat`` (streamed and not, system messages merged, tools,
``format``, ``keep_alive`` 0, images refused, tools refused without a
``.Tools`` section), ``/v1/chat/completions`` (streamed and not, tools,
``response_format`` json_object and json_schema), ``/v1/completions`` and
``/v1/models``. Bodies must be equal once the timestamps, ids and
durations are dropped, and streamed frame sequences must be equal at
``stream_flush_tokens`` 1, 3 and 16 with ``stream_flush_ms`` large. The
stream coalescer's unit cases run against the JAX package's on the same
inputs.
"""

from __future__ import annotations

import json
import os
import time
import types
import urllib.error
import urllib.request
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.errors import BadRequest as JBadRequest
from ollama_operator_tpu.runtime.service import LoadedModel as JLoadedModel
from ollama_operator_tpu.server import app as japp
from ollama_operator_tpu.server.names import ModelName as JModelName
from ollama_operator_tpu.server.registry import ModelStore as JModelStore
from ollama_operator_tpu.server.template import Template as JTemplate
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models import decoder as pdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime.engine import EngineConfig
from ollama_operator_tpu_torch.runtime.service import LoadedModel
from ollama_operator_tpu_torch.server import app as papp
from ollama_operator_tpu_torch.tokenizer import Tokenizer
from test_torch_grammar import VOCAB

torch.set_num_threads(1)

CHAT_TPL = ("{{ if .Tools }}[tools]{{ range .Tools }}{{ .Function.Name }};"
            "{{ end }}{{ end }}"
            "{{ range .Messages }}[{{ .Role }}]{{ .Content }}"
            "{{ if .ToolCalls }}{{ range .ToolCalls }}{{ json .Function }}"
            "{{ end }}{{ end }}{{ end }}[assistant]")
# buckets of 64 and 128 positions only: few JAX compiles
ENGINE = dict(paged=False, max_slots=4, max_seq_len=128,
              min_prefill_bucket=64, decode_chunk=4)
GREEDY = {"temperature": 0, "num_predict": 10, "stream_flush_ms": 1e6}
TOOLS = [{"type": "function",
          "function": {"name": "weather", "description": "the weather",
                       "parameters": {"type": "object", "properties": {
                           "city": {"type": "string"}}}}}]
# a schema inside the supported subset that forces a tool invocation
CALL = {"type": "object",
        "properties": {"name": {"enum": ["weather"]},
                       "arguments": {"type": "object", "properties": {
                           "city": {"enum": ["paris", "rome"]}}}}}
SCHEMA = {"type": "object",
          "properties": {"ok": {"type": "boolean"},
                         "n": {"type": "integer"}}}
DROP = {"created_at", "id", "created", "total_duration", "load_duration",
        "prompt_eval_duration", "eval_duration"}


@pytest.fixture(scope="module")
def servers(tmp_path_factory):
    """(JAX port, torch port): each server holds one model "tiny" on the
    same weights (dense f32 cache, prefill in one shot)."""
    init = jax.jit(lambda k: jdec.init_params(JPRESETS["tiny"], k,
                                              jnp.float32))
    params = jax.tree_util.tree_map(np.asarray, init(jax.random.key(5)))
    env = {"TPU_WARM_BUCKETS": "0", "TPU_PREFILL_CHUNK": "0"}
    with mock.patch.dict(os.environ, env):
        # the JAX manager finds its model by the short name ("tiny:latest")
        jlm = JLoadedModel("tiny:latest", JPRESETS["tiny"],
                           jax.tree_util.tree_map(jnp.asarray, params),
                           JTokenizer(model="llama", **VOCAB),
                           template=CHAT_TPL,
                           ecfg=JEngineConfig(cache_dtype=jnp.float32,
                                              **ENGINE))
        lm = LoadedModel("tiny", TPRESETS["tiny"],
                         params_from_numpy(params, device="cpu"),
                         Tokenizer(model="llama", **VOCAB), template=CHAT_TPL,
                         device="cpu",
                         ecfg=EngineConfig(cache_dtype=torch.float32,
                                           **ENGINE))
    jmm = japp.ModelManager(str(tmp_path_factory.mktemp("jstore")))
    jmm.loaded = jlm
    pmm = papp.ModelManager(device="cpu")
    pmm.add(lm)
    jhttpd = japp.serve(jmm, "127.0.0.1", 0)
    phttpd = papp.serve(pmm, "127.0.0.1", 0)
    try:
        yield jhttpd.server_address[1], phttpd.server_address[1]
    finally:
        for h in (jhttpd, phttpd):
            h.shutdown()
            h.server_close()
        jmm.shutdown()
        pmm.shutdown()


def _call(port, path, body=None):
    """(status, content type, raw body) of one request."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.headers.get("Content-Type"), r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.headers.get("Content-Type"), e.read().decode()


def _strip(x):
    if isinstance(x, dict):
        return {k: _strip(v) for k, v in x.items() if k not in DROP}
    if isinstance(x, list):
        return [_strip(v) for v in x]
    if isinstance(x, str) and x.startswith("call_chatcmpl-"):
        return "call_" + x.rsplit("_", 1)[-1]   # the call id's index
    return x


def _frames(ctype, raw):
    """A response's frames, parsed (NDJSON lines, or SSE events with the
    final ``[DONE]`` kept as the string)."""
    if ctype == "text/event-stream":
        out = []
        for ev in raw.split("\n\n"):
            if ev.startswith("data: "):
                data = ev[len("data: "):]
                out.append(data if data == "[DONE]" else json.loads(data))
        return out
    return [json.loads(x) for x in raw.splitlines() if x.strip()]


def _both(servers, path, body=None):
    """The same request to the JAX server and then to the port's: both
    statuses, content types and frame lists, stamps dropped."""
    out = []
    for port in servers:
        status, ctype, raw = _call(port, path, body)
        frames = _frames(ctype, raw)
        out.append((status, ctype, _strip(frames)))
    return out


def _same(servers, path, body=None):
    (js, jc, jf), (ps, pc, pf) = _both(servers, path, body)
    assert (ps, pc) == (js, jc)
    assert pf == jf
    return ps, pf


MESSAGES = [{"role": "system", "content": "be brief"},
            {"role": "user", "content": "hello"},
            {"role": "system", "content": "and kind"}]


def test_chat_not_streamed_merges_system(servers):
    status, frames = _same(servers, "/api/chat", {
        "model": "tiny", "messages": MESSAGES, "stream": False,
        "options": GREEDY})
    assert status == 200 and len(frames) == 1
    out = frames[0]
    assert out["done"] and out["message"]["role"] == "assistant"
    assert 0 < out["eval_count"] <= 10


@pytest.mark.parametrize("flush", [1, 3, 16])
def test_chat_stream_frames(servers, flush):
    status, frames = _same(servers, "/api/chat", {
        "model": "tiny", "messages": MESSAGES[:2],
        "options": dict(GREEDY, stream_flush_tokens=flush)})
    assert status == 200 and frames[-1]["done"]
    body = frames[:-1]
    # the first piece goes out alone, then a frame every `flush` tokens
    assert len(body) >= 2 and len(body) <= 1 + -(-9 // flush) + 1
    text = "".join(f["message"]["content"] for f in body)
    full = _same(servers, "/api/chat", {
        "model": "tiny", "messages": MESSAGES[:2], "stream": False,
        "options": GREEDY})[1][0]
    assert text == full["message"]["content"]


def test_chat_second_turn_carries_the_first_answer(servers):
    first = _same(servers, "/api/chat", {
        "model": "tiny", "messages": MESSAGES[:2], "stream": False,
        "options": GREEDY})[1][0]["message"]
    status, frames = _same(servers, "/api/chat", {
        "model": "tiny", "stream": False, "options": GREEDY,
        "messages": MESSAGES[:2] + [first,
                                    {"role": "user", "content": "more"}]})
    assert status == 200 and frames[0]["prompt_eval_count"] > 0


@pytest.mark.parametrize("stream", [False, True])
def test_chat_tools_and_forced_call(servers, stream):
    """Tools render through ``.Tools``; a schema that forces an invocation
    comes back as ``tool_calls``, streamed as one message frame."""
    status, frames = _same(servers, "/api/chat", {
        "model": "tiny", "messages": MESSAGES[1:2], "tools": TOOLS,
        "format": CALL, "stream": stream,
        "options": dict(GREEDY, num_predict=60)})
    assert status == 200
    msg = frames[0]["message"]
    assert msg["tool_calls"][0]["function"]["name"] == "weather"
    assert msg["tool_calls"][0]["function"]["arguments"]["city"] in (
        "paris", "rome")
    assert frames[-1]["done_reason"] == "stop"
    assert len(frames) == (2 if stream else 1)


@pytest.mark.parametrize("fmt", ["json", SCHEMA])
def test_chat_format(servers, fmt):
    status, frames = _same(servers, "/api/chat", {
        "model": "tiny", "messages": MESSAGES[1:2], "format": fmt,
        "stream": False, "options": dict(GREEDY, num_predict=24)})
    assert status == 200
    out = frames[0]
    if out["done_reason"] == "stop":
        json.loads(out["message"]["content"])


def _stand_in():
    """The reference's LoadedModel as its render_chat and generate_stream
    read it up to their refusals."""
    return types.SimpleNamespace(
        name="tiny", template=JTemplate("{{ .Prompt }}"), system=None,
        default_params={}, vision=None,
        tokenizer=JTokenizer(model="llama", **VOCAB),
        engine=types.SimpleNamespace(max_seq=128))


def test_chat_refusals_as_the_reference(servers, tmp_path):
    _, port = servers
    # images: the reference's refusal for a model without a projector
    with pytest.raises(JBadRequest) as e:
        JLoadedModel.generate_stream(_stand_in(), "hi",
                                     images=[np.zeros((2, 2, 3), np.uint8)])
    status, _, raw = _call(port, "/api/chat", {
        "model": "tiny", "options": GREEDY, "messages": [
            {"role": "user", "content": "hi", "images": ["aGVsbG8="]}]})
    assert (status, json.loads(raw)["error"]) == (400, str(e.value))
    # tools on a template without .Tools
    with pytest.raises(JBadRequest) as e:
        JLoadedModel.render_chat(_stand_in(), MESSAGES, tools=TOOLS)
    pmm = papp.ModelManager(device="cpu")
    lm = LoadedModel("tiny", TPRESETS["tiny"],
                     pdec.init_params(TPRESETS["tiny"],
                                      torch.Generator().manual_seed(0),
                                      torch.float32, "cpu"),
                     Tokenizer(model="llama", **VOCAB),
                     template="{{ .Prompt }}", device="cpu",
                     ecfg=EngineConfig(cache_dtype=torch.float32, **ENGINE))
    pmm.add(lm)
    httpd = papp.serve(pmm, "127.0.0.1", 0)
    p2 = httpd.server_address[1]
    try:
        status, _, raw = _call(p2, "/api/chat", {
            "model": "tiny", "messages": MESSAGES, "tools": TOOLS})
        assert (status, json.loads(raw)["error"]) == (400, str(e.value))
        # keep_alive 0 with no messages unloads, as the reference answers
        jstatus, _, jraw = _call(servers[0], "/api/chat", {
            "model": "absent", "messages": [], "keep_alive": 0})
        status, _, raw = _call(p2, "/api/chat", {
            "model": "tiny", "messages": [], "keep_alive": 0})
        assert status == jstatus == 200
        assert _strip(json.loads(raw)) == dict(
            _strip(json.loads(jraw)), model="tiny")
        assert json.loads(raw)["done_reason"] == "unload"
        assert pmm.list_models() == [] and lm.scheduler._stop
    finally:
        httpd.shutdown()
        httpd.server_close()
        pmm.shutdown()


OAI = [{"role": "system", "content": "be brief"},
       {"role": "user", "content": "hello"}]


@pytest.mark.parametrize("flush", ["1", "3", "16"])
def test_openai_chat_stream_frames(servers, flush, monkeypatch):
    monkeypatch.setenv("TPU_STREAM_FLUSH_TOKENS", flush)
    monkeypatch.setenv("TPU_STREAM_FLUSH_MS", "1000000")
    status, frames = _same(servers, "/v1/chat/completions", {
        "model": "tiny", "messages": OAI, "stream": True, "temperature": 0,
        "max_tokens": 10})
    assert status == 200 and frames[-1] == "[DONE]"
    assert frames[0]["choices"][0]["delta"] == {"role": "assistant",
                                                "content": ""}
    assert frames[-2]["choices"][0]["finish_reason"] in ("stop", "length")
    text = "".join(f["choices"][0]["delta"].get("content", "")
                   for f in frames[1:-2])
    full = _same(servers, "/v1/chat/completions", {
        "model": "tiny", "messages": OAI, "temperature": 0,
        "max_tokens": 10})[1][0]
    assert text == full["choices"][0]["message"]["content"]
    assert 0 < full["usage"]["completion_tokens"] <= 10


@pytest.mark.parametrize("rf", [
    {"type": "json_object"},
    {"type": "json_schema", "json_schema": {"name": "s", "schema": SCHEMA}}])
def test_openai_response_format(servers, rf):
    status, frames = _same(servers, "/v1/chat/completions", {
        "model": "tiny", "messages": OAI, "temperature": 0,
        "max_tokens": 24, "response_format": rf})
    assert status == 200
    choice = frames[0]["choices"][0]
    if choice["finish_reason"] == "stop":
        json.loads(choice["message"]["content"])


@pytest.mark.parametrize("stream", [False, True])
def test_openai_tool_calls(servers, stream):
    status, frames = _same(servers, "/v1/chat/completions", {
        "model": "tiny", "messages": OAI, "temperature": 0,
        "max_tokens": 60, "tools": TOOLS, "stream": stream,
        "response_format": {"type": "json_schema",
                            "json_schema": {"schema": CALL}}})
    assert status == 200
    if stream:
        assert frames[-1] == "[DONE]"
        call = frames[0]["choices"][0]["delta"]["tool_calls"][0]
        assert call["index"] == 0
        assert frames[1]["choices"][0]["finish_reason"] == "tool_calls"
    else:
        call = frames[0]["choices"][0]["message"]["tool_calls"][0]
        assert frames[0]["choices"][0]["finish_reason"] == "tool_calls"
    assert call["function"]["name"] == "weather"
    assert json.loads(call["function"]["arguments"])["city"] in ("paris",
                                                                 "rome")


def test_openai_completions(servers):
    status, frames = _same(servers, "/v1/completions", {
        "model": "tiny", "prompt": "once", "temperature": 0,
        "max_tokens": 10})
    assert status == 200
    out = frames[0]
    assert out["object"] == "text_completion"
    assert out["usage"]["completion_tokens"] == 10
    assert out["usage"]["total_tokens"] == (out["usage"]["prompt_tokens"]
                                            + 10)


def test_openai_models(tmp_path):
    """Both managers over one store list its model alike; the port's also
    lists a model built in-process."""
    store = JModelStore(str(tmp_path))
    store.write_manifest(JModelName.parse("stored"), {
        "schemaVersion": 2, "config": {"digest": "sha256:" + "0" * 64},
        "layers": []})
    jmm = japp.ModelManager(str(tmp_path))
    pmm = papp.ModelManager(str(tmp_path), device="cpu")
    jh, ph = japp.serve(jmm, "127.0.0.1", 0), papp.serve(pmm, "127.0.0.1", 0)
    try:
        got = [_call(h.server_address[1], "/v1/models") for h in (jh, ph)]
        assert got[1] == got[0]
        assert json.loads(got[1][2]) == {"object": "list", "data": [
            {"id": "stored:latest", "object": "model", "created": 0,
             "owned_by": "library"}]}
    finally:
        for h in (jh, ph):
            h.shutdown()
            h.server_close()
        jmm.shutdown()
        pmm.shutdown()


# -- the stream coalescer ---------------------------------------------------

def test_resolve_stream_flush_matches_jax(monkeypatch):
    cases = [None, {}, {"stream_flush_tokens": 0, "stream_flush_ms": -5},
             {"stream_flush_tokens": "bogus"}, {"stream_flush_ms": 7}]
    for env in ({}, {"TPU_STREAM_FLUSH_TOKENS": "4",
                     "TPU_STREAM_FLUSH_MS": "100"}):
        for k in ("TPU_STREAM_FLUSH_TOKENS", "TPU_STREAM_FLUSH_MS"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        for o in cases:
            assert (papp.resolve_stream_flush(o)
                    == japp.resolve_stream_flush(o)), (env, o)
    assert papp.resolve_stream_flush({}) == (4, 0.1)
    assert papp.STREAM_FLUSH_TOKENS == japp.STREAM_FLUSH_TOKENS == 16


class _P(str):
    n_tokens = 1


def _piece(text, n):
    p = _P(text)
    p.n_tokens = n
    return p


@pytest.mark.parametrize("pieces,max_tokens", [
    (["a", "b", "c", "defg", "h", "tail"], 4),
    ([("x", 1), ("eight-token chunk", 8), ("y", 3), ("z", 5), ("", 0)], 8),
    ([("one", 1), ("two", 2), ("three", 3)], 1)])
def test_coalescer_frames_match_jax(pieces, max_tokens):
    """The first piece goes out at once; then a frame every `max_tokens`
    tokens, counting each piece's ``n_tokens``."""
    got = []
    for mod in (japp, papp):
        frames = []
        co = mod._StreamCoalescer(frames.append, lambda s: s,
                                  max_tokens=max_tokens, max_s=3600.0)
        for p in pieces:
            co.add(_piece(*p) if isinstance(p, tuple) else p)
        co.flush()
        got.append((frames, co.frames))
    assert got[0] == got[1]
    assert got[1][0][0] == (pieces[0][0] if isinstance(pieces[0], tuple)
                            else pieces[0])


def test_coalescer_time_flush():
    frames = []
    co = papp._StreamCoalescer(frames.append, lambda s: s, max_tokens=100,
                               max_s=0.01)
    co.add("a")
    co.add("b")
    time.sleep(0.02)
    co.add("c")                  # past max_s since the last frame
    assert frames == ["a", "bc"]
