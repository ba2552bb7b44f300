"""Grammar-constrained decoding (``format``) through the port's
``LoadedModel`` held against the JAX package's on the same requests, on
the CPU at the tiny preset.

Greedy token streams are the oracle (a sampled stream of the port draws
from ``torch.Generator``, which cannot match the JAX package's bits):
``format: "json"``, a JSON schema, a schema whose output is forced to
completion (it must end with "stop" and parse), a request with
``repeat_penalty`` 1.3, and a prompt prefilled in pieces, each on the
paged int8 pool and on the dense cache. The port runs them with the
device grammar table (``TPU_GRAMMAR_DEVICE`` 1) and with host masks
(``TPU_GRAMMAR_DEVICE`` 0), and with a table of 4 states
(``TPU_GRAMMAR_STATES=4``), where the device walk escapes and the host
rolls the lengths back; every setting must give the JAX package's
streams, which do not depend on these knobs. Then a mixed batch (one
constrained slot beside three free ones: the free streams equal their
runs alone) and a constrained request preempted on a small pool and
resumed under its current mask.
"""

from __future__ import annotations

import json
import os
import threading
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops.constrain import INITIAL_STATE, advance_bytes
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.service import LoadedModel as JLoadedModel
from ollama_operator_tpu.server.metrics import GLOBAL as JMETRICS
from ollama_operator_tpu.tokenizer import Tokenizer as JTokenizer
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.runtime.engine import EngineConfig
from ollama_operator_tpu_torch.runtime.service import LoadedModel
from ollama_operator_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

# the tiny preset's 256 ids: an end-of-generation control piece, a few
# multi-byte JSON pieces, and byte pieces for bytes 0x00..0xF2
MULTI = ["true", "false", "null", '{"', '":', '",', '"}', "},", "12", "ab",
         "▁the", "\\u00"]
VOCAB = dict(tokens=["</s>"] + MULTI
             + [f"<0x{b:02X}>" for b in range(256 - 1 - len(MULTI))],
             token_types=[3] + [1] * len(MULTI)
             + [6] * (256 - 1 - len(MULTI)),
             eos_id=0)
TPL = "{{ .Prompt }}"
SCHEMA = {"type": "object",
          "properties": {"name": {"type": "string"},
                         "age": {"type": "integer"},
                         "tags": {"type": "array",
                                  "items": {"type": "string"}}}}
FORCED = {"type": "object",
          "properties": {"k": {"enum": ["cat", "dog"]},
                         "ok": {"type": "boolean"}}}
GREEDY = {"temperature": 0, "num_predict": 12}
# (format, prompt, extra options) within a 32-position context: two
# attention buckets keep the JAX package's compiles few
REQUESTS = [
    ("json", "hello there", {}),
    (SCHEMA, "person", {}),
    ("json", "key value", {"repeat_penalty": 1.3}),
    (FORCED, "forced", {"num_predict": 20}),
    # a whitespace, then a number: leaves a table of 4 states
    ("json", "value", {}),
]
# the paged pool prefills every prompt of more than 8 tokens in pieces of
# 8 (TPU_PREFILL_CHUNK, read when the scheduler is built), whose bits
# differ from a one-shot prefill's; the dense cache prefills in one shot
CACHES = {"paged-int8": dict(paged=True, kv="int8", min_prefill_bucket=8,
                             env={"TPU_PREFILL_CHUNK": "8"}),
          "dense-f32": dict(paged=False, kv="float32", min_prefill_bucket=32,
                            env={"TPU_PREFILL_CHUNK": "0"})}
ENGINE = dict(max_slots=4, max_seq_len=32, page_size=16, decode_chunk=4)


def _env(cache):
    """The cache's prefill knob, set for the duration of a block."""
    return mock.patch.dict(os.environ, CACHES[cache]["env"])


@pytest.fixture(scope="module")
def numpy_params():
    init = jax.jit(lambda k: jdec.init_params(JPRESETS["tiny"], k,
                                              jnp.float32))
    return jax.tree_util.tree_map(np.asarray, init(jax.random.key(3)))


def _run(lm, requests=REQUESTS):
    out = []
    for fmt, prompt, extra in requests:
        final = None
        for _piece, res in lm.generate_stream(prompt, dict(GREEDY, **extra),
                                              format=fmt):
            final = res or final
        out.append(final)
    return out


@pytest.fixture(scope="module")
def reference(numpy_params):
    """The JAX LoadedModel's results for REQUESTS on each cache (device
    grammar tables on, 64 states: its defaults)."""
    refs = {}
    for name, c in CACHES.items():
        with _env(name), mock.patch.dict(os.environ,
                                         {"TPU_WARM_BUCKETS": "0"}):
            jlm = JLoadedModel(
                "tiny", JPRESETS["tiny"],
                jax.tree_util.tree_map(jnp.asarray, numpy_params),
                JTokenizer(model="llama", **VOCAB), template=TPL,
                ecfg=JEngineConfig(paged=c["paged"],
                                   cache_dtype=getattr(jnp, c["kv"]),
                                   min_prefill_bucket=c["min_prefill_bucket"],
                                   **ENGINE))
        chunks = JMETRICS.get("tpu_model_prefill_chunks_total")
        try:
            refs[name] = _run(jlm)
            refs[name + ":chunks"] = (
                JMETRICS.get("tpu_model_prefill_chunks_total") - chunks)
        finally:
            jlm.unload()
    return refs


def _port(numpy_params, cache, **kw):
    c = CACHES[cache]
    ecfg = dict(ENGINE, paged=c["paged"], cache_dtype=getattr(torch, c["kv"]),
                min_prefill_bucket=c["min_prefill_bucket"])
    ecfg.update(kw)
    with _env(cache):
        return LoadedModel("tiny", TPRESETS["tiny"],
                           params_from_numpy(numpy_params, device="cpu"),
                           Tokenizer(model="llama", **VOCAB), template=TPL,
                           device="cpu", ecfg=EngineConfig(**ecfg))


KNOBS = {"device-64": {"TPU_GRAMMAR_DEVICE": "1"},
         "host": {"TPU_GRAMMAR_DEVICE": "0"},
         "device-4": {"TPU_GRAMMAR_DEVICE": "1", "TPU_GRAMMAR_STATES": "4"}}


@pytest.mark.parametrize("cache", list(CACHES))
@pytest.mark.parametrize("knob", list(KNOBS))
def test_constrained_greedy_streams_match_jax(numpy_params, reference,
                                              monkeypatch, cache, knob):
    monkeypatch.delenv("TPU_GRAMMAR_STATES", raising=False)
    for k, v in KNOBS[knob].items():
        monkeypatch.setenv(k, v)
    lm = _port(numpy_params, cache)
    try:
        got = _run(lm)
        escapes = lm.scheduler.n_grammar_escapes
        pieces = lm.scheduler.n_prefill_pieces
        assert lm.engine._gstates_cap == (4 if knob == "device-4" else 64)
        assert lm.engine._grammar_device == (knob != "host")
    finally:
        lm.unload()
    ref = reference[cache]
    tok = Tokenizer(model="llama", **VOCAB)
    assert len(got) == len(ref) == len(REQUESTS)
    for (fmt, _p, _e), r, g in zip(REQUESTS, ref, got):
        assert g.context == r.context, fmt
        assert (g.text, g.done_reason, g.generated_tokens) == (
            r.text, r.done_reason, r.generated_tokens)
        data = b"".join(tok.piece_bytes(t)
                        for t in g.context[g.prompt_tokens:])
        if fmt == "json":
            assert advance_bytes(INITIAL_STATE, data) is not None
        if g.done_reason == "stop":
            json.loads(data)
    # the forced schema completes, and its keys come in the schema's order
    forced = json.loads(got[3].text)
    assert got[3].done_reason == "stop"
    assert list(forced) == ["k", "ok"]
    assert forced["k"] in ("cat", "dog") and forced["ok"] in (True, False)
    assert (pieces >= 4) if cache == "paged-int8" else (pieces == 0)
    assert reference[cache + ":chunks"] == pieces
    if knob == "device-4":
        assert escapes >= 1, "a 4-state table must be left at least once"
    if knob == "host":
        assert escapes == 0


def _concurrent(lm, jobs):
    out = [None] * len(jobs)

    def run(i):
        fmt, prompt = jobs[i]
        final = None
        for _piece, res in lm.generate_stream(prompt, GREEDY, format=fmt):
            final = res or final
        out[i] = final

    ts = [threading.Thread(target=run, args=(i,)) for i in range(len(jobs))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in ts)
    return out


@pytest.mark.parametrize("knob", ["device-64", "host"])
def test_mixed_batch_free_streams_unchanged(numpy_params, monkeypatch, knob):
    """One constrained slot beside three free ones: the free slots keep
    whole chunks and their streams equal their runs alone (and so does
    the constrained one's)."""
    for k, v in KNOBS[knob].items():
        monkeypatch.setenv(k, v)
    jobs = [("json", "value"), (None, "free a"), (None, "free bb"),
            (None, "free ccc")]
    lm = _port(numpy_params, "paged-int8", cache_dtype=torch.float32)
    try:
        alone = [_concurrent(lm, [j])[0] for j in jobs]
        mixed = _concurrent(lm, jobs)
    finally:
        lm.unload()
    assert [m.context for m in mixed] == [a.context for a in alone]
    assert all(m.done_reason == "length" for m in mixed[1:])


def test_preempted_constrained_request_resumes(numpy_params):
    """On a pool too small for four requests the newest slots are
    preempted and re-admitted under their current masks; every stream
    equals the run on a pool that never runs dry."""
    jobs = [(SCHEMA, "one"), (SCHEMA, "two"), (SCHEMA, "six"),
            ("json", "ten")]
    outs, preempted = [], []
    for n_pages in (None, 4):
        lm = _port(numpy_params, "paged-int8", cache_dtype=torch.float32,
                   n_pages=n_pages)
        try:
            outs.append(_concurrent(lm, jobs))
            preempted.append(lm.scheduler.n_preempted)
            lm.engine._pt.check()
        finally:
            lm.unload()
    assert preempted[0] == 0 and preempted[1] > 0
    assert [r.context for r in outs[1]] == [r.context for r in outs[0]]
    for r in outs[1]:
        assert advance_bytes(INITIAL_STATE, r.text.encode()) is not None
