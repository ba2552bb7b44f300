"""The embedding and model-authoring routes of the port's server against
the JAX handler, on the CPU, each manager on its own store holding the
same pulled models (``tests/test_torch_registry.py``'s fake registry:
the tiny llama and a tiny BERT encoder).

- ``/api/embed``, ``/api/embeddings`` and ``/v1/embeddings`` on the
  decoder and on the encoder: the same statuses and keys, vectors within
  1e-4 of the JAX ones (f32 on both sides), one text's vector the same
  from all three routes; a bad ``keep_alive`` 400 in both; generation on
  the encoder 400 with the JAX message; ``/api/ps`` of the encoder;
- ``POST /api/blobs/<digest>`` 201 and ``HEAD`` 200; a bad digest 400 on
  POST (404 on HEAD) before any file is touched; a body that does not
  hash to its digest, and a body cut short (EOF mid-body), 400 with the
  connection closed and no partial blob left;
- ``/api/create`` by ``files`` (with template, system and parameters),
  by ``from`` (a store model: its layers inherited, parameters merged)
  and by a Modelfile naming a server-side GGUF; ``FROM @<missing>`` 400
  (non-streamed) or an error line (streamed), streamed progress lines;
  both stores end byte-identical;
- ``/api/copy`` and ``/api/show`` of the copy; a missing source 404;
- ``/api/push`` of both packages to the fake registry, streamed and not:
  the same progress statuses and equal manifests in the registry.
"""

import hashlib
import json
import socket

import numpy as np

from ollama_operator_tpu_torch.server.names import ModelName
from ollama_operator_tpu_torch.server.registry import MT_MODEL
from test_torch_registry import (_call, _json, _ref, _tree, managers,  # noqa: F401
                                 registry, servers)

TEXTS = ["the sky is blue", "why", "embed me please, vector search"]


def _both(p, j, *args):
    return _call(p, *args), _call(j, *args)


def _pull(port, jm, ref):
    port.pull(ref)
    jm.client.pull(ref)


def test_embedding_routes_answer_as_the_jax_handler(servers, registry):
    _reg, host = registry
    port, jm, p, j = servers()
    tiny, bert = _ref(host, "tiny"), _ref(host, "bert")
    _pull(port, jm, bert)
    for model in (tiny, bert):
        (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/embed",
                                   {"model": model, "input": TEXTS,
                                    "keep_alive": "5m"})
        assert s1 == s2 == 200
        a, b = _json(t1), _json(t2)
        assert sorted(a) == sorted(b) == ["embeddings", "model", "object"]
        np.testing.assert_allclose(a["embeddings"], b["embeddings"],
                                   rtol=1e-4, atol=1e-4)
        one = a["embeddings"][2]
        (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/embeddings",
                                   {"model": model, "prompt": TEXTS[2]})
        assert s1 == s2 == 200
        np.testing.assert_allclose(_json(t1)["embedding"],
                                   _json(t2)["embedding"],
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(_json(t1)["embedding"], one,
                                   rtol=1e-5, atol=1e-5)
        (s1, t1), (s2, t2) = _both(p, j, "POST", "/v1/embeddings",
                                   {"model": model, "input": TEXTS[2]})
        assert s1 == s2 == 200
        a, b = _json(t1), _json(t2)
        assert {k: v for k, v in a.items() if k != "data"} == {
            k: v for k, v in b.items() if k != "data"}
        assert [d["index"] for d in a["data"]] == [0]
        np.testing.assert_allclose(a["data"][0]["embedding"], one,
                                   rtol=1e-5, atol=1e-5)
        (s1, _), (s2, _) = _both(p, j, "POST", "/api/embed",
                                 {"model": model, "input": "x",
                                  "keep_alive": "soon"})
        assert s1 == s2 == 400
    # the encoder is resident now: generation is refused as in JAX
    for path, body in (("/api/generate", {"model": bert, "prompt": "hi"}),
                       ("/api/chat", {"model": bert, "messages": [
                           {"role": "user", "content": "hi"}]})):
        (s1, t1), (s2, t2) = _both(p, j, "POST", path, body)
        assert (s1, _json(t1)) == (s2, _json(t2))
        assert s1 == 400 and "embedding model" in _json(t1)["error"]
    (s1, t1), (s2, t2) = _both(p, j, "GET", "/api/ps")
    a, b = _json(t1)["models"], _json(t2)["models"]
    assert [m["name"] for m in a] == [m["name"] for m in b]
    for k in ("name", "size", "digest"):
        assert a[0][k] == b[0][k], k
    for k in ("family", "serving_dtype", "decode_chunk", "paged"):
        assert a[0]["details"][k] == b[0]["details"][k], k
    assert "kernel_launches" in a[0]
    (s1, _), (s2, _) = _both(p, j, "GET", "/metrics")
    assert s1 == s2 == 200


def _raw_post(port, path, head_len, body, close_write=False):
    """POST ``body`` with a declared Content-Length of ``head_len``; with
    ``close_write`` the client half-closes (EOF mid-body). Returns the
    status and, for an error, whether the server closed the
    connection."""
    s = socket.create_connection(("127.0.0.1", port), timeout=30)
    try:
        s.sendall(f"POST {path} HTTP/1.1\r\nHost: x\r\nContent-Length: "
                  f"{head_len}\r\n\r\n".encode() + body)
        if close_write:
            s.shutdown(socket.SHUT_WR)
        data = b""
        while b"\r\n\r\n" not in data:
            chunk = s.recv(4096)
            if not chunk:
                break
            data += chunk
        status = int(data.split(b" ", 2)[1])
        if status < 400:
            return status, None
        # an error closes the connection: a read past the response ends
        # (a kept-alive one would wait for the next request)
        s.settimeout(2.0)
        try:
            while s.recv(4096):
                pass
            closed = True
        except socket.timeout:
            closed = False
        return status, closed
    finally:
        s.close()


def test_blob_upload_and_head(servers, registry):
    port, jm, p, j = servers()
    data = b"a small blob " * 100
    digest = "sha256:" + hashlib.sha256(data).hexdigest()
    for srv in (p, j):
        assert _call(srv, "HEAD", f"/api/blobs/{digest}")[0] == 404
        assert _raw_post(srv, f"/api/blobs/{digest}", len(data),
                         data)[0] == 201
        assert _call(srv, "HEAD", f"/api/blobs/{digest}")[0] == 200
        # again: the body is read and dropped, still 201
        assert _raw_post(srv, f"/api/blobs/{digest}", len(data),
                         data)[0] == 201
        for bad in ("sha256:../../etc", "md5:" + "0" * 64,
                    "sha256:" + "A" * 64):
            assert _call(srv, "HEAD", f"/api/blobs/{bad}")[0] == 404
            assert _raw_post(srv, f"/api/blobs/{bad}", 4, b"abcd") == (
                400, True)
        other = b"other bytes"
        wrong = "sha256:" + hashlib.sha256(b"not these").hexdigest()
        assert _raw_post(srv, f"/api/blobs/{wrong}", len(other),
                         other) == (400, True)
        cut = "sha256:" + hashlib.sha256(other * 10).hexdigest()
        assert _raw_post(srv, f"/api/blobs/{cut}", len(other) * 10, other,
                         close_write=True) == (400, True)
        assert _call(srv, "HEAD", f"/api/blobs/{cut}")[0] == 404
        assert _raw_post(srv, f"/api/blobs/{digest}", 0, b"")[0] == 400
    assert _tree(port.store.root) == _tree(jm.store.root)
    assert not any(".partial" in k for k in _tree(port.store.root))


def _create_lines(text):
    return [json.loads(x) for x in text.splitlines() if x.strip()]


def test_create_copy_and_show_as_the_jax_handler(servers, registry,
                                                 tmp_path):
    _reg, host = registry
    port, jm, p, j = servers()
    with open(port.store.model_layers(ModelName.parse(_ref(
            host, "tiny")))[MT_MODEL], "rb") as f:
        gguf = f.read()
    digest = "sha256:" + hashlib.sha256(gguf).hexdigest()
    for srv in (p, j):
        assert _raw_post(srv, f"/api/blobs/{digest}", len(gguf),
                         gguf)[0] == 201
    by_files = {"model": "made:files", "files": {"tiny.gguf": digest},
                "template": "{{ .Prompt }}!", "system": "be short",
                "parameters": {"temperature": 0, "stop": ["a", "b"]},
                "stream": False}
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/create", by_files)
    assert (s1, _json(t1)) == (s2, _json(t2)) == (200, {"status":
                                                        "success"})
    # FROM a store model: its template kept, system replaced, parameters
    # merged; streamed progress
    mf = ("FROM made:files\nSYSTEM \"\"\"be long\"\"\"\n"
          "PARAMETER top_k 7\n")
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/create",
                               {"model": "made:derived", "modelfile": mf})
    assert s1 == s2 == 200
    assert _create_lines(t1) == _create_lines(t2)
    assert _create_lines(t1)[-1] == {"status": "success"}
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/create",
                               {"model": "made:from", "from": "made:files",
                                "stream": False})
    assert s1 == s2 == 200
    path = str(tmp_path / "local.gguf")
    with open(path, "wb") as f:
        f.write(gguf)
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/create",
                               {"model": "made:path",
                                "modelfile": f"FROM {path}\n"})
    assert s1 == s2 == 200
    assert [e["status"] for e in _create_lines(t1)] == [
        e["status"] for e in _create_lines(t2)] == [
        "importing model blob", "success"]
    missing = "sha256:" + "0" * 64
    for stream in (False, True):
        (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/create", {
            "model": "made:none", "modelfile": f"FROM @{missing}",
            "stream": stream})
        assert (s1, _json(t1)) == (s2, _json(t2))
        if stream:
            assert s1 == 200 and "blob not uploaded" in t1
        else:
            assert s1 == 400
    (s1, _), (s2, _) = _both(p, j, "POST", "/api/create",
                             {"model": "made:x", "modelfile": "SYSTEM hi",
                              "stream": False})
    assert s1 == s2 == 400
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/copy",
                               {"source": "made:derived",
                                "destination": "copied:latest"})
    assert (s1, _json(t1)) == (s2, _json(t2)) == (200, {})
    (s1, _), (s2, _) = _both(p, j, "POST", "/api/copy",
                             {"source": "nope", "destination": "x"})
    assert s1 == s2 == 404
    (s1, _), (s2, _) = _both(p, j, "POST", "/api/copy", {"source": "a"})
    assert s1 == s2 == 400
    for name in ("made:derived", "copied:latest", "made:files"):
        (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/show",
                                   {"model": name})
        assert s1 == s2 == 200
        a, b = _json(t1), _json(t2)
        assert {k: a[k] for k in a if k != "details"} == {
            k: b[k] for k in b if k != "details"}
    show = _json(_call(p, "POST", "/api/show", {"model": "copied:latest"})[1])
    assert show["system"] == "be long" and show["template"] == (
        "{{ .Prompt }}!")
    assert "top_k" in show["parameters"] and "temperature" in show[
        "parameters"]
    assert _tree(port.store.root) == _tree(jm.store.root)
    # the created model serves
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/generate", {
        "model": "copied:latest", "prompt": "hi", "stream": False,
        "options": {"num_predict": 4}})
    assert s1 == s2 == 200
    assert _json(t1)["context"] == _json(t2)["context"]


def test_push_round_trips(servers, registry):
    reg, host = registry
    port, jm, p, j = servers()
    src = _ref(host, "tiny")
    for srv, name, stream in ((p, "pushed-port", True),
                              (j, "pushed-jax", True),
                              (p, "pushed-port2", False),
                              (j, "pushed-jax2", False)):
        dst = _ref(host, f"{name}:v1")
        assert _call(srv, "POST", "/api/copy", {
            "source": src, "destination": dst})[0] == 200
        status, text = _call(srv, "POST", "/api/push",
                             {"model": dst, "stream": stream})
        assert status == 200
        lines = _create_lines(text)
        assert lines[-1] == {"status": "success"}
        if stream:
            assert lines[-2] == {"status": "pushing manifest"}
            assert all("digest" in e for e in lines[:-2])
    m = reg.manifests
    assert m[("library", "pushed-port", "v1")] == m[
        ("library", "pushed-jax", "v1")] == m[("library", "tiny", "latest")]
    assert m[("library", "pushed-port2", "v1")] == m[
        ("library", "pushed-jax2", "v1")]
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/push",
                               {"model": "nowhere:1", "stream": False})
    assert s1 == s2 == 500
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/push",
                               {"model": "nowhere:1"})
    assert s1 == s2 == 200
    assert "error" in _create_lines(t1)[-1] and "error" in _create_lines(
        t2)[-1]
