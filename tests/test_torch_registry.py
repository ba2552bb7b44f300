"""Pull and serve: the port's registry client, model manager and HTTP
routes against the JAX package's, on the CPU at the tiny preset.

``tests/fake_registry.py`` serves a tiny llama GGUF (byte-fallback
vocabulary) with template and params layers on the loopback.

- ``RegistryClient.pull`` of both packages into two stores gives identical
  file trees and bytes;
- (``test_torch_gguf_serving.py`` and ``test_torch_gguf_quant.py`` serve
  the pulled models through both packages' ``ModelManager.load``);
- ``/api/tags``, ``/api/show``, ``/api/ps``, ``/api/delete`` and
  ``/api/pull`` (streamed and not) answer with the JAX handler's status
  codes and keys on the same store;
- the keep-alive reaper unloads an idle store model (a stepped clock), and
  the next request loads it again;
- a model with an adapter or projector layer, an encoder, and an arch the
  port's decoder refuses are each refused with 501; a store-only manager
  refuses generation with 503.
"""

import json
import os
import threading
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fake_registry import FakeRegistry
from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.server import app as japp
from ollama_operator_tpu.server.registry import ModelStore as JModelStore
from ollama_operator_tpu.server.registry import \
    RegistryClient as JRegistryClient
from ollama_operator_tpu.server.registry import RegistryError as JRegistryError
from ollama_operator_tpu_torch.runtime.engine import EngineConfig
from ollama_operator_tpu_torch.server import app as tapp
from ollama_operator_tpu_torch.server.registry import (MT_ADAPTER,
                                                       ModelStore,
                                                       RegistryClient,
                                                       RegistryError)
from ollama_operator_tpu_torch.gguf import writer as W
from test_torch_gguf import write_port_gguf

torch.set_num_threads(1)

TPL = "{{ .Prompt }}"
PARAMS = {"temperature": 0, "num_predict": 12, "stop": ["zzz"]}
BYTES_MD = {"tokenizer.ggml.model": "llama",
            "tokenizer.ggml.tokens": [f"<0x{i:02X}>" for i in range(256)],
            "tokenizer.ggml.scores": [0.0] * 256,
            "tokenizer.ggml.token_type": [6] * 256,
            "tokenizer.ggml.add_bos_token": False}
PROMPTS = ["quick brown fox", "pull then serve"]


def _tiny_gguf(path, seed=4, **kw):
    p = jdec.init_params(JPRESETS["tiny"], jax.random.key(seed), jnp.float32)
    return write_port_gguf(path, jax.tree_util.tree_map(np.asarray, p),
                           tokenizer_md=BYTES_MD, **kw)


def _header_gguf(path, arch, **fields):
    """A GGUF with an arch's header fields and no tensors: enough for the
    manager to read its config and refuse it."""
    w = W.GGUFWriter(path)
    w.add_meta("general.architecture", arch)
    for k, v in fields.items():
        w.add_meta(f"{arch}.{k}", v)
    for k, v in BYTES_MD.items():
        w.add_meta(k, v)
    w.write()
    return path


@pytest.fixture(scope="module")
def registry(tmp_path_factory):
    d = tmp_path_factory.mktemp("reg")
    reg = FakeRegistry()
    gguf = open(_tiny_gguf(str(d / "tiny.gguf")), "rb").read()
    reg.add_model("library", "tiny", "latest", gguf, template=TPL,
                  params=PARAMS, system="be brief")
    reg.add_model("library", "tied", "q4", open(_tiny_gguf(
        str(d / "tied.gguf"), seed=5, tied=True, llama3=True), "rb").read(),
        template=TPL, params=PARAMS)
    reg.add_model("library", "adapter", "latest", gguf, template=TPL)
    reg.manifests[("library", "adapter", "latest")]["layers"].append(
        {"mediaType": MT_ADAPTER, **reg.add_blob(b"lora bytes")})
    reg.add_model("library", "projector", "latest", gguf, template=TPL,
                  projector_bytes=b"mmproj bytes")
    dims = dict(block_count=2, embedding_length=64, feed_forward_length=128)
    reg.add_model("library", "bert", "latest", open(_header_gguf(
        str(d / "bert.gguf"), "bert", **dims,
        **{"attention.head_count": 4}), "rb").read())
    reg.add_model("library", "qwen3", "latest", open(_header_gguf(
        str(d / "qwen3.gguf"), "qwen3", **dims,
        **{"attention.head_count": 4, "attention.head_count_kv": 2}),
        "rb").read())
    url = reg.start()
    yield reg, url.split("://", 1)[1]
    reg.stop()


def _tree(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def _ref(host, name):
    return f"http://{host}/library/{name}"


@pytest.mark.parametrize("name", ["tiny:latest", "tied:q4", "adapter"])
def test_pull_gives_the_jax_store(tmp_path, registry, name):
    _reg, host = registry
    events, jevents = [], []
    got = RegistryClient(ModelStore(str(tmp_path / "port"))).pull(
        _ref(host, name), lambda *a, **k: events.append((a, k)))
    ref = JRegistryClient(JModelStore(str(tmp_path / "jax"))).pull(
        _ref(host, name), lambda *a, **k: jevents.append((a, k)))
    assert got.short == ref.short
    assert events == jevents
    port_tree, jax_tree = _tree(tmp_path / "port"), _tree(tmp_path / "jax")
    assert sorted(port_tree) == sorted(jax_tree)
    assert port_tree == jax_tree
    assert any(k.startswith("manifests/") for k in port_tree)
    # pulling again is a no-op in both
    RegistryClient(ModelStore(str(tmp_path / "port"))).pull(_ref(host, name))
    assert _tree(tmp_path / "port") == jax_tree


def test_pull_of_a_missing_model_fails_in_both(tmp_path, registry):
    _reg, host = registry
    with pytest.raises(RegistryError, match="not found"):
        RegistryClient(ModelStore(str(tmp_path / "p"))).pull(
            _ref(host, "nope"))
    with pytest.raises(JRegistryError, match="not found"):
        JRegistryClient(JModelStore(str(tmp_path / "j"))).pull(
            _ref(host, "nope"))


def _ecfg(jax_side):
    kw = dict(paged=False, max_slots=2, max_seq_len=128,
              min_prefill_bucket=16, decode_chunk=8)
    if jax_side:
        return JEngineConfig(cache_dtype=jnp.float32, **kw)
    return EngineConfig(cache_dtype=torch.float32, **kw)


@pytest.fixture
def managers(tmp_path, registry, monkeypatch):
    """A port and a JAX model manager on the CPU, each with its own store
    holding the pulled models."""
    monkeypatch.setenv("TPU_WARM_BUCKETS", "0")
    _reg, host = registry
    made = []

    def make(engine_dtype=None, store_only=False):
        tag = f"m{len(made)}"
        port = tapp.ModelManager(
            str(tmp_path / tag / "port"), cache_dir=str(tmp_path / tag / "pc"),
            device="cpu", ecfg=_ecfg(False), engine_dtype=engine_dtype,
            serve_models=not store_only)
        jm = japp.ModelManager(
            str(tmp_path / tag / "jax"), cache_dir=str(tmp_path / tag / "jc"),
            ecfg=_ecfg(True), engine_dtype=engine_dtype,
            serve_models=not store_only)
        for name in ("tiny:latest", "tied:q4"):
            port.pull(_ref(host, name))
            jm.client.pull(_ref(host, name))
        made.append((port, jm))
        return port, jm

    yield make
    for port, jm in made:
        port.shutdown()
        jm.unload_now()
        jm.shutdown()


# ---------------------------------------------------------------------------
# HTTP routes
# ---------------------------------------------------------------------------

def _call(port, method, path, body=None):
    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method=method,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, r.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def _json(text):
    lines = [json.loads(x) for x in text.splitlines() if x.strip()]
    return lines[0] if len(lines) == 1 else lines


@pytest.fixture
def servers(managers):
    started = []

    def make(**kw):
        port, jm = managers(**kw)
        a, b = tapp.serve(port, "127.0.0.1", 0), japp.serve(jm, "127.0.0.1",
                                                           0)
        started.extend([a, b])
        return port, jm, a.server_address[1], b.server_address[1]

    yield make
    for h in started:
        h.shutdown()
        h.server_close()


def _keys(x):
    if isinstance(x, list):
        return [_keys(e) for e in x]
    if isinstance(x, dict):
        return sorted(x)
    return type(x).__name__


def test_routes_answer_as_the_jax_handler(servers, registry):
    _reg, host = registry
    port, jm, p, j = servers()
    both = lambda *a: (_call(p, *a), _call(j, *a))  # noqa: E731

    (s1, t1), (s2, t2) = both("GET", "/api/tags")
    assert s1 == s2 == 200
    a, b = _json(t1), _json(t2)
    assert [m["name"] for m in a["models"]] == [m["name"] for m in
                                                b["models"]]
    assert _keys(a) == _keys(b)
    for ma, mb in zip(a["models"], b["models"]):
        assert _keys(ma) == _keys(mb)
        assert ma["details"] == mb["details"]
        assert (ma["size"], ma["digest"]) == (mb["size"], mb["digest"])

    for body in ({"model": _ref(host, "tiny")}, {"name": "nope"}):
        (s1, t1), (s2, t2) = both("POST", "/api/show", body)
        assert s1 == s2
        if s1 == 200:
            a, b = _json(t1), _json(t2)
            assert _keys(a) == _keys(b)
            assert {k: a[k] for k in a if k != "details"} == {
                k: b[k] for k in b if k != "details"}
        else:
            assert s1 == 404
    (s1, _), (s2, _) = both("POST", "/api/show", {})
    assert s1 == s2 == 400

    (s1, t1), (s2, t2) = both("GET", "/api/ps")
    assert (s1, _json(t1)) == (s2, _json(t2)) == (200, {"models": []})
    gen = {"model": _ref(host, "tiny"), "prompt": "hi", "stream": False}
    (s1, t1), (s2, t2) = both("POST", "/api/generate", gen)
    assert s1 == s2 == 200
    assert _json(t1)["context"] == _json(t2)["context"]
    (s1, t1), (s2, t2) = both("GET", "/api/ps")
    assert s1 == s2 == 200
    a, b = _json(t1)["models"], _json(t2)["models"]
    assert len(a) == len(b) == 1
    assert set(a[0]) - {"kernel_launches"} <= set(b[0])
    assert set(a[0]["details"]) <= set(b[0]["details"])
    for k in ("name", "model", "size", "digest"):
        assert a[0][k] == b[0][k], k
    assert a[0]["details"]["serving_dtype"] == "float32"
    assert a[0]["kernel_launches"]["qmm"] == 0    # the CPU launches none

    for stream in (True, False):
        body = {"model": _ref(host, "tied:q4"), "stream": stream}
        (s1, t1), (s2, t2) = both("POST", "/api/pull", body)
        assert s1 == s2 == 200
        a, b = _json(t1), _json(t2)
        if stream:
            assert [e["status"] for e in a] == [e["status"] for e in b]
            assert a[-1] == {"status": "success"}
        else:
            assert a == b == {"status": "success"}
    (s1, t1), (s2, t2) = both("POST", "/api/pull",
                              {"model": _ref(host, "nope")})
    assert s1 == s2 == 200
    assert "error" in _json(t1)[-1] and "error" in _json(t2)[-1]
    (s1, t1), (s2, t2) = both("POST", "/api/pull",
                              {"model": _ref(host, "nope"), "stream": False})
    assert s1 == s2 == 500

    (s1, t1), (s2, t2) = both("DELETE", "/api/delete",
                              {"model": _ref(host, "tiny")})
    assert (s1, _json(t1)) == (s2, _json(t2)) == (200, {})
    assert port.ps() == [] and jm.loaded is None
    (s1, _), (s2, _) = both("DELETE", "/api/delete",
                            {"model": _ref(host, "tiny")})
    assert s1 == s2 == 404
    (s1, _), (s2, _) = both("POST", "/api/delete",
                            {"model": _ref(host, "tied:q4")})
    assert s1 == s2 == 200
    assert _tree(port.store.root) == _tree(jm.store.root)
    (s1, _), (s2, _) = both("HEAD", "/")
    assert s1 == s2 == 200
    (s1, _), (s2, _) = both("POST", "/api/generate",
                            {"model": "gone", "prompt": "x"})
    assert s1 == s2 == 404


def test_store_only_refuses_generation(servers, registry):
    _reg, host = registry
    port, jm, p, j = servers(store_only=True)
    assert port.device is None
    for body in ({"model": _ref(host, "tiny"), "prompt": "hi"},
                 {"model": _ref(host, "tiny")}):
        s1, t1 = _call(p, "POST", "/api/generate", body)
        s2, t2 = _call(j, "POST", "/api/generate", body)
        assert s1 == s2 == 503
        assert "model store" in _json(t1)["error"]
    s1, t1 = _call(p, "GET", "/api/tags")
    assert s1 == 200 and len(_json(t1)["models"]) == 2


@pytest.mark.parametrize("name,what", [
    ("adapter", "ADAPTER"), ("projector", "PROJECTOR"),
    ("bert", "embedding model"), ("qwen3", "qk_norm")])
def test_unported_models_are_refused(tmp_path, registry, name, what):
    _reg, host = registry
    mm = tapp.ModelManager(str(tmp_path / "s"), cache_dir=str(
        tmp_path / "c"), device="cpu", ecfg=_ecfg(False))
    httpd = tapp.serve(mm, "127.0.0.1", 0)
    try:
        mm.pull(_ref(host, name))
        status, text = _call(httpd.server_address[1], "POST",
                             "/api/generate", {"model": _ref(host, name),
                                               "prompt": "hi"})
        assert status == 501
        assert what in _json(text)["error"]
        with pytest.raises(tapp.ApiError) as e:
            mm.load(_ref(host, name))
        assert e.value.status == 501
        assert mm.ps() == []
        assert not os.path.exists(str(tmp_path / "c"))   # nothing transcoded
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()


# ---------------------------------------------------------------------------
# keep-alive
# ---------------------------------------------------------------------------

class StepClock:
    def __init__(self):
        self.t = 1000.0

    def __call__(self):
        return self.t


def test_idle_reaper_unloads_and_the_next_request_reloads(tmp_path, registry,
                                                           monkeypatch):
    _reg, host = registry
    monkeypatch.delenv("OLLAMA_KEEP_ALIVE", raising=False)
    clock = StepClock()
    mm = tapp.ModelManager(str(tmp_path / "s"), cache_dir=str(
        tmp_path / "c"), device="cpu", ecfg=_ecfg(False), clock=clock,
        reap_every_s=3600)
    try:
        assert mm.default_keep_alive == 300.0
        ref = _ref(host, "tiny")
        mm.pull(ref)
        lm = mm.require_loaded(ref, keep_alive="2s")
        first = lm.generate("hi").context
        clock.t += 1.5
        assert mm.reap_idle() == []
        mm.touch(lm, mm.keep_alive_s("2s"))   # a request ended: re-armed
        clock.t += 1.5
        assert mm.reap_idle() == []
        # a model with a request waiting or running is never reaped
        clock.t += 10
        monkeypatch.setattr(type(lm.scheduler), "has_pending",
                            property(lambda self: True))
        assert mm.reap_idle() == []
        monkeypatch.undo()
        assert mm.reap_idle() == [lm.name]
        assert mm.ps() == [] and lm.scheduler._stop
        lm2 = mm.require_loaded(ref)
        assert lm2 is not lm and lm2.generate("hi").context == first
        assert mm.ps()[0]["expires_at"] != "0001-01-01T00:00:00Z"
        mm.require_loaded(ref, keep_alive=-1)       # forever
        clock.t += 1e6
        assert mm.reap_idle() == []
        assert mm.ps()[0]["expires_at"] == "0001-01-01T00:00:00Z"
        with pytest.raises(tapp.ApiError) as e:
            mm.require_loaded(ref, keep_alive="soon")
        assert e.value.status == 400
    finally:
        mm.shutdown()


def test_keep_alive_default_from_env(tmp_path, monkeypatch):
    monkeypatch.setenv("OLLAMA_KEEP_ALIVE", "90s")
    mm = tapp.ModelManager(str(tmp_path / "s"), serve_models=False)
    assert mm.default_keep_alive == 90.0
    monkeypatch.setenv("OLLAMA_KEEP_ALIVE", "whenever")
    mm2 = tapp.ModelManager(str(tmp_path / "s"), serve_models=False)
    assert mm2.default_keep_alive == 300.0
    for m in (mm, mm2):
        m.shutdown()


def test_in_process_models_are_never_reaped(tmp_path, registry):
    """A model built in-process has no source to come back from: it has
    no deadline, however long it idles."""
    clock = StepClock()
    mm = tapp.ModelManager(str(tmp_path / "s"), device="cpu", clock=clock,
                           reap_every_s=3600, default_keep_alive=0)
    try:
        p = jdec.init_params(JPRESETS["tiny"], jax.random.key(0),
                             jnp.float32)
        from ollama_operator_tpu_torch.convert import params_from_numpy
        from ollama_operator_tpu_torch.models.config import PRESETS
        from ollama_operator_tpu_torch.tokenizer import Tokenizer
        lm = mm.preload("own", PRESETS["tiny"], params_from_numpy(
            jax.tree_util.tree_map(np.asarray, p), device="cpu"),
            Tokenizer.from_gguf_metadata(BYTES_MD), ecfg=_ecfg(False))
        mm.require_loaded("own")
        clock.t += 1e6
        assert mm.reap_idle() == []
        assert mm.require_loaded("own") is lm
        assert [m["name"] for m in mm.list_models()] == ["own"]
    finally:
        mm.shutdown()


def test_concurrent_requests_load_once(tmp_path, registry):
    _reg, host = registry
    mm = tapp.ModelManager(str(tmp_path / "s"), cache_dir=str(
        tmp_path / "c"), device="cpu", ecfg=_ecfg(False))
    try:
        ref = _ref(host, "tiny")
        mm.pull(ref)
        got = [None] * 3
        ts = [threading.Thread(target=lambda i=i: got.__setitem__(
            i, mm.require_loaded(ref))) for i in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert got[0] is got[1] is got[2] is not None
        assert len(os.listdir(str(tmp_path / "c"))) == 1
    finally:
        mm.shutdown()


@pytest.mark.parametrize("paged", [True, None])
def test_min_prefill_bucket_knob_read_as_jax(monkeypatch, paged):
    """``TPU_MIN_PREFILL_BUCKET`` sets the prefill-bucket floor in the
    port's ``resolve_serving_defaults`` as in the JAX resolver (the
    server's only path to it)."""
    from ollama_operator_tpu.runtime.engine import \
        resolve_serving_defaults as jresolve
    from ollama_operator_tpu_torch.models.config import PRESETS
    from ollama_operator_tpu_torch.runtime.engine import \
        resolve_serving_defaults
    for env in (None, "16"):
        if env is None:
            monkeypatch.delenv("TPU_MIN_PREFILL_BUCKET", raising=False)
        else:
            monkeypatch.setenv("TPU_MIN_PREFILL_BUCKET", env)
        kw = dict(max_slots=0 if paged is None else 4, paged=paged,
                  max_seq_len=128, decode_chunk=0, page_size=0)
        got = resolve_serving_defaults(EngineConfig(**kw), PRESETS["tiny"],
                                       "cpu")
        want = jresolve(JEngineConfig(**kw), JPRESETS["tiny"], None)
        assert got.min_prefill_bucket == want.min_prefill_bucket == (
            64 if env is None else 16)
