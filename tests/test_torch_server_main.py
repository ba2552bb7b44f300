"""``python -m ollama_operator_tpu_torch.server`` and the pull CLI in
subprocesses on the CPU, as a deployment starts them: a store-only server,
``python -m ollama_operator_tpu_torch.server.pull`` against it (through
``$OLLAMA_HOST``), then a model server with ``--device cpu --preload`` on
the pulled store that answers ``/api/generate`` with the tokens of an
in-process load of the same store. Without CUDA the default ``--device
cuda`` exits non-zero with its message; parallel plans are refused at
startup, and so is the preload of a model whose adapter layer is no GGUF,
with the reference's "adapter: ..." message.
"""

import json
import os
import pathlib
import signal
import socket
import subprocess
import sys
import time
import urllib.error
import urllib.request

import pytest
import torch

from test_torch_registry import _ecfg, _ref, registry  # noqa: F401
from ollama_operator_tpu_torch.server import app as tapp

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
SERVER = [sys.executable, "-m", "ollama_operator_tpu_torch.server",
          "--host", "127.0.0.1"]


def _env(**kw):
    env = {k: v for k, v in os.environ.items()
           if not k.lower().endswith("_proxy")}
    env.update(OMP_NUM_THREADS="1", OLLAMA_KEEP_ALIVE="5m",
               CUDA_VISIBLE_DEVICES="", **kw)
    return env


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(args, tmp_path, name):
    log = open(tmp_path / f"{name}.log", "w+")
    proc = subprocess.Popen(SERVER + args, cwd=ROOT, env=_env(),
                            stdout=log, stderr=subprocess.STDOUT)
    return proc, log


def _wait_ready(proc, log, port, timeout=90):
    t0 = time.time()
    while time.time() - t0 < timeout:
        if proc.poll() is not None:
            log.seek(0)
            raise AssertionError(f"server exited {proc.returncode}: "
                                 f"{log.read()}")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/",
                                        timeout=2) as r:
                if r.status == 200:
                    return
        except OSError:
            time.sleep(0.2)
    raise AssertionError("server did not come up")


def _stop(proc):
    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
        try:
            return proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    return proc.returncode


def _post(port, path, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}", data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=120) as r:
        return json.loads(r.read())


def test_store_pull_then_serve(tmp_path, registry):
    _reg, host = registry
    store, cache = str(tmp_path / "store"), str(tmp_path / "cache")
    ref = _ref(host, "tiny:latest")
    sp, mp = _free_port(), _free_port()
    store_proc, slog = _start(["--store-only", "--store", store,
                               "--port", str(sp)], tmp_path, "store")
    procs = [store_proc]
    try:
        _wait_ready(store_proc, slog, sp)
        pull = subprocess.run(
            [sys.executable, "-m", "ollama_operator_tpu_torch.server.pull",
             ref], cwd=ROOT, env=_env(OLLAMA_HOST=f"127.0.0.1:{sp}"),
            capture_output=True, text=True, timeout=120)
        assert pull.returncode == 0, pull.stderr
        events = [json.loads(x) for x in pull.stdout.splitlines()]
        assert events[0]["status"] == "pulling manifest"
        assert events[-1] == {"status": "success"}
        with urllib.request.urlopen(f"http://127.0.0.1:{sp}/api/tags",
                                    timeout=30) as r:
            tags = json.loads(r.read())["models"]
        # the store's layout keeps the registry's host, not its scheme
        assert [m["name"] for m in tags] == [f"{host}/tiny:latest"]
        # the store serves no inference
        req = urllib.request.Request(
            f"http://127.0.0.1:{sp}/api/generate",
            data=json.dumps({"model": ref, "prompt": "hi"}).encode())
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req, timeout=30)
        assert e.value.code == 503
        assert _stop(store_proc) == 0

        model_proc, mlog = _start(
            ["--device", "cpu", "--store", store, "--cache", cache,
             "--preload", ref, "--port", str(mp), "--max-slots", "2",
             "--max-seq-len", "128", "--decode-chunk", "8"],
            tmp_path, "model")
        procs.append(model_proc)
        _wait_ready(model_proc, mlog, mp, timeout=120)
        out = _post(mp, "/api/generate", {"model": ref, "prompt": "hi",
                                          "stream": False})
        assert out["done"] and out["eval_count"] == 12
        with urllib.request.urlopen(f"http://127.0.0.1:{mp}/api/ps",
                                    timeout=30) as r:
            ps = json.loads(r.read())["models"]
        assert ps[0]["details"]["serving_dtype"] == "float32"
        assert os.listdir(cache)      # the transcode was cached
        assert _stop(model_proc) == 0
        mlog.seek(0)
        assert "serving dtype for" in mlog.read()
        # an in-process load of the same store gives the same tokens
        mm = tapp.ModelManager(store, cache_dir=cache, device="cpu",
                               ecfg=_ecfg(False))
        try:
            lm = mm.load(ref)
            assert lm.engine.ecfg.max_slots == 2
            assert lm.generate("hi").context == out["context"]
        finally:
            mm.shutdown()
    finally:
        for p in procs:
            _stop(p)


@pytest.mark.parametrize("args,message", [
    ([], "CUDA is not available; pass --device cpu"),
    (["--device", "cpu", "--tp", "2"], "not ported yet"),
    (["--device", "cpu", "--preload", "PRELOAD"],
     "adapter: "),
])
def test_startup_refusals(tmp_path, registry, args, message):
    _reg, host = registry
    store = str(tmp_path / "store")
    if "PRELOAD" in args:
        mm = tapp.ModelManager(store, serve_models=False)
        mm.pull(_ref(host, "adapter"))
        args = [a.replace("PRELOAD", _ref(host, "adapter")) for a in args]
    run = subprocess.run(SERVER + ["--store", store, "--port", "0"] + args,
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=120)
    assert run.returncode != 0
    assert message in run.stderr
