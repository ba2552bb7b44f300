"""The port's serving slice end to end, on the CPU at the tiny preset.

- greedy token streams of the port's ``LoadedModel`` (int8 paged pool)
  equal the JAX package's ``LoadedModel`` with its paged engine, for three
  concurrent requests on identical weights;
- the weight dtype resolved per model and device agrees with the JAX
  package's for every preset (the card in the place of the TPU);
- the HTTP surface: ``/api/generate`` streamed and not, ``/api/tags``,
  ``/api/version``;
- seeded sampling replays exactly (seeded non-greedy streams cannot match
  the JAX package's threefry bits; greedy parity is the cross-framework
  gate and determinism is the sampled path's own);
- hygiene: nothing in the port package or ``chip_smoke.py`` imports JAX
  or the JAX package, and the entry points refuse to fall back to the
  CPU when CUDA is missing.
"""

import ast
import json
import pathlib
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import \
    resolve_engine_dtype as jresolve_engine_dtype
from ollama_operator_tpu.runtime.service import LoadedModel as JLoadedModel
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      resolve_cache_dtype,
                                                      resolve_engine_dtype,
                                                      resolve_serving_defaults)
from ollama_operator_tpu_torch.runtime.service import LoadedModel
from ollama_operator_tpu_torch.server.app import ModelManager, serve
from ollama_operator_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
TPL = "{{ .Prompt }}"
PROMPTS = ["the quick brown fox", "paged attention", "x"]
GREEDY = {"temperature": 0, "num_predict": 12}
BYTES = dict(tokens=[f"<0x{i:02X}>" for i in range(256)],
             token_types=[6] * 256)   # byte-fallback pieces only


@pytest.fixture(scope="module")
def numpy_params():
    p = jdec.init_params(JPRESETS["tiny"], jax.random.key(3), jnp.float32)
    return jax.tree_util.tree_map(np.asarray, p)


def _port_model(numpy_params, **kw):
    ecfg = dict(paged=True, max_slots=4, max_seq_len=128,
                cache_dtype=torch.int8, page_size=16, min_prefill_bucket=16,
                decode_chunk=8)
    ecfg.update(kw)
    return LoadedModel(
        "tiny", TPRESETS["tiny"],
        params_from_numpy(numpy_params, device="cpu"),
        Tokenizer(model="llama", **BYTES), template=TPL, device="cpu",
        ecfg=EngineConfig(**ecfg))


def _concurrent(lm, prompts, options):
    out = [None] * len(prompts)

    def run(i):
        out[i] = lm.generate(prompts[i], options)

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(out))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return out


def test_greedy_streams_match_jax_loaded_model(numpy_params, monkeypatch):
    monkeypatch.setenv("TPU_WARM_BUCKETS", "0")
    jlm = JLoadedModel(
        "tiny", JPRESETS["tiny"],
        jax.tree_util.tree_map(jnp.asarray, numpy_params),
        JTokenizer(model="llama", **BYTES), template=TPL,
        ecfg=JEngineConfig(paged=True, max_slots=4, max_seq_len=128,
                           cache_dtype=jnp.int8, page_size=16,
                           min_prefill_bucket=16, decode_chunk=8))
    try:
        ref = _concurrent(jlm, PROMPTS, GREEDY)
    finally:
        jlm.unload()
    lm = _port_model(numpy_params)
    try:
        got = _concurrent(lm, PROMPTS, GREEDY)
    finally:
        lm.unload()
    for r, g in zip(ref, got):
        assert g.context == r.context
        assert (g.generated_tokens, g.done_reason) == (12, "length")
        assert (r.generated_tokens, r.done_reason) == (12, "length")


def test_seeded_sampling_replays(numpy_params):
    lm = _port_model(numpy_params)
    try:
        opts = {"temperature": 0.9, "top_k": 20, "top_p": 0.95,
                "min_p": 0.02, "seed": 1234, "num_predict": 16}
        a = _concurrent(lm, ["sample me", "other"], opts)
        b = _concurrent(lm, ["sample me", "other"], opts)
        c = lm.generate("sample me", dict(opts, seed=99))
    finally:
        lm.unload()
    assert [r.context for r in a] == [r.context for r in b]
    assert c.context != a[0].context


def test_preemption_keeps_greedy_streams(numpy_params):
    """A pool too small for three concurrent requests preempts the newest
    slots and re-admits them from prompt + generated tokens; the streams
    equal those of a pool that never runs dry."""
    opts = {"temperature": 0, "num_predict": 40}
    prompts = ["first prompt here", "second one", "and a third"]
    outs = []
    for n_pages in (None, 8):
        lm = _port_model(numpy_params, cache_dtype=torch.float32,
                         n_pages=n_pages)
        try:
            outs.append(_concurrent(lm, prompts, opts))
            preempted = lm.scheduler.n_preempted
            lm.engine._pt.check()              # no page leaked or doubled
            # every page is free or held by the radix prefix cache
            assert lm.engine._pt.n_free == (lm.engine._pt.data_pages
                                            - lm.engine.radix_pages)
        finally:
            lm.unload()
    assert preempted > 0
    assert [r.context for r in outs[0]] == [r.context for r in outs[1]]
    assert all(r.generated_tokens == 40 for r in outs[1])


def _post(port, body):
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.read().decode()


def test_http_generate_and_tags(numpy_params):
    mm = ModelManager(device="cpu")
    mm.add(_port_model(numpy_params))
    httpd = serve(mm, "127.0.0.1", 0)
    port = httpd.server_address[1]
    try:
        lines = _post(port, {"model": "tiny", "prompt": "hi there",
                             "options": GREEDY}).strip().split("\n")
        frames = [json.loads(x) for x in lines]
        assert all(not f["done"] for f in frames[:-1])
        last = frames[-1]
        assert last["done"] and last["eval_count"] == 12
        assert last["done_reason"] == "length"
        streamed = "".join(f["response"] for f in frames)
        whole = json.loads(_post(port, {"model": "tiny", "stream": False,
                                        "prompt": "hi there",
                                        "options": GREEDY}))
        assert whole["done"] and whole["response"] == streamed
        assert whole["context"] == last["context"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/tags", timeout=10) as r:
            tags = json.loads(r.read())
        assert [m["name"] for m in tags["models"]] == ["tiny"]
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/api/version", timeout=10) as r:
            assert "version" in json.loads(r.read())
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(port, {"model": "nope", "prompt": "x"})
        assert e.value.code == 404
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_no_jax():
    """Nothing in the port or ``chip_smoke.py`` imports JAX, ``ml_dtypes``
    (the card's machine has neither) or the JAX package; ``chip_smoke.py``
    imports nothing from ``tests/`` either."""
    files = sorted((ROOT / "ollama_operator_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    for mod in ("runtime/radix.py", "gguf/reader.py", "gguf/dequant.py",
                "gguf/writer.py", "gguf/store.py", "gguf/transcode.py",
                "server/names.py", "server/registry.py",
                "server/modelfile.py", "server/pull.py",
                "server/__main__.py", "ops/constrain.py", "ops/schema.py",
                "server/tools.py", "runtime/errors.py", "runtime/faults.py",
                "runtime/admission.py", "runtime/trace.py",
                "runtime/accounting.py", "server/metrics.py",
                "models/encoder.py"):
        assert ROOT / "ollama_operator_tpu_torch" / mod in files, mod
    for f in files:
        for name in _imports(f):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "ml_dtypes",
                               "ollama_operator_tpu"), (
                f"{f.relative_to(ROOT)} imports {name}")
    test_modules = {p.stem for p in (ROOT / "tests").rglob("*.py")}
    assert "fake_registry" in test_modules
    for name in _imports(ROOT / "chip_smoke.py"):
        top = name.split(".")[0]
        assert top not in test_modules | {"tests"}, (
            f"chip_smoke.py imports {name} from tests/")


def test_entry_points_refuse_cpu_fallback(numpy_params, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TPRESETS["tiny"]
    params = params_from_numpy(numpy_params, device="cpu")
    tok = Tokenizer(model="llama", **BYTES)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Engine(cfg, params, EngineConfig(paged=True, max_slots=2,
                                         max_seq_len=64, page_size=16))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        LoadedModel("tiny", cfg, params, tok)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ModelManager()


def test_serving_defaults_on_the_card():
    cfg = TPRESETS["llama3.1"]
    e = resolve_serving_defaults(
        EngineConfig(paged=True, max_slots=0, decode_chunk=0, page_size=0,
                     max_seq_len=4096), cfg, "cuda")
    assert (e.max_slots, e.page_size, e.n_pages, e.decode_chunk) == (
        64, 128, 768, 32)


def test_engine_dtype_resolution_matches_jax():
    for name, cfg in TPRESETS.items():
        jcfg = JPRESETS[name]
        assert resolve_engine_dtype(cfg, "cuda") == \
            jresolve_engine_dtype(jcfg, "tpu"), name
        assert resolve_engine_dtype(cfg, "cpu") == \
            jresolve_engine_dtype(jcfg, "cpu") == "float32", name
    assert resolve_engine_dtype(TPRESETS["llama3.2:3b"], "cuda") == "int8"
    assert resolve_engine_dtype(TPRESETS["llama3.1"], "cuda") == "int4"
    assert resolve_cache_dtype("int4") == "int4"
    assert resolve_cache_dtype("int8") is torch.int8
    with pytest.raises(ValueError):
        resolve_cache_dtype("int2")

