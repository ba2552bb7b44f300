"""Mirostat v1/v2 in the port (``ops/sampling.py``, the engine's ``mu``)
against the JAX package's ``sample`` and engine.

- For slots under mirostat 1 and 2 (and one under the static filters)
  the JAX ``sample`` runs with its draw captured: its truncated,
  temperature-scaled candidate logits and the candidate it drew. The
  port's keep mask (``mirostat_keep``) equals the JAX truncation, its
  renormalised distribution (``renormalised``) the JAX one, and its
  ``mu`` update (``mirostat_update``) fed the token JAX drew gives JAX's
  ``mu'`` (the draws themselves differ: the port's generators are not
  threefry);
- the port's ``sample`` draws inside the keep mask and moves ``mu`` by
  that update, live mirostat slots only;
- ``mu`` is seeded to 2·tau at admission, in the port as in the JAX
  engine, and a decode moves only the live mirostat slots';
- ``merge_options`` takes ``mirostat``, ``mirostat_tau``, ``mirostat_eta``
  as the JAX one does (a value other than 1/2 is off, a bad one the same
  400), and a mirostat request is served: seeded streams repeat
  themselves, every token in the vocabulary;
- the scheduler classes a mirostat stream "nondeterministic" for replay,
  as the JAX scheduler does.
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops import sampling as jsampling
from ollama_operator_tpu.runtime.engine import Engine as JEngine
from ollama_operator_tpu.runtime.engine import EngineConfig as JEngineConfig
from ollama_operator_tpu.runtime.engine import SlotOptions as JSlotOptions
from ollama_operator_tpu.runtime.scheduler import Request as JRequest
from ollama_operator_tpu.runtime.scheduler import Scheduler as JScheduler
from ollama_operator_tpu.runtime.service import BadRequest as JBadRequest
from ollama_operator_tpu.runtime.service import \
    merge_options as jmerge_options
from ollama_operator_tpu_torch.convert import params_from_numpy
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.ops import sampling as tsampling
from ollama_operator_tpu_torch.runtime.engine import (Engine, EngineConfig,
                                                      SlotOptions)
from ollama_operator_tpu_torch.runtime.scheduler import Request, Scheduler
from ollama_operator_tpu_torch.runtime.service import (BadRequest,
                                                       LoadedModel,
                                                       merge_options)
from ollama_operator_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)

FIELDS = ("temperature", "top_k", "top_p", "min_p", "typical_p",
          "repeat_penalty", "presence_penalty", "frequency_penalty",
          "mirostat", "mirostat_tau", "mirostat_eta")
# slot rows: mirostat 2 and 1 at several temperatures and budgets, one
# slot under the static filters, one greedy mirostat slot
ROWS = [dict(temperature=0.7, mirostat=2, mirostat_tau=5.0, mirostat_eta=0.1),
        dict(temperature=1.0, mirostat=2, mirostat_tau=3.0, mirostat_eta=0.2),
        dict(temperature=0.9, mirostat=1, mirostat_tau=5.0, mirostat_eta=0.1),
        dict(temperature=1.3, mirostat=1, mirostat_tau=4.0, mirostat_eta=0.3),
        dict(temperature=0.8, mirostat=0),
        dict(temperature=0.0, mirostat=2)]


def _rows():
    out = []
    for r in ROWS:
        row = dict(dataclasses.asdict(SlotOptions()), **r)
        row["repeat_penalty"] = 1.2
        out.append(row)
    return out


def _jax_params(rows):
    B = len(rows)
    sp = jsampling.SamplingParams.make(B)
    return dataclasses.replace(sp, **{
        k: jnp.asarray([r[k] for r in rows],
                       jnp.int32 if k in ("top_k", "mirostat")
                       else jnp.float32) for k in FIELDS})


def _jax_sample_captured(logits, counts, jsp, mu, key):
    """JAX ``sample`` with its draw captured: (tokens, mu', the logits it
    drew from [B, C], the candidate index it drew [B])."""
    seen = {}
    real = jax.random.categorical

    def spy(k, filt, axis=-1, **kw):
        ci = real(k, filt, axis=axis, **kw)
        seen["filt"], seen["ci"] = np.asarray(filt), np.asarray(ci)
        return ci
    with mock.patch.object(jax.random, "categorical", spy):
        toks, mu2 = jsampling.sample(jnp.asarray(logits), jnp.asarray(counts),
                                     jsp, key, jnp.asarray(mu))
    return np.asarray(toks), np.asarray(mu2), seen["filt"], seen["ci"]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_keep_mask_distribution_and_mu_update_equal_jax(seed):
    rng = np.random.default_rng(seed)
    rows = _rows()
    B, V = len(rows), 1500
    # a Zipf-like head, so v1's fit sees a real slope
    logits = (rng.standard_normal((B, V)) * 2.0
              - 1.5 * np.log1p(np.arange(V))[rng.permutation(V)]
              ).astype(np.float32)
    counts = rng.integers(0, 2, (B, V)).astype(np.int32)
    mu = np.array([2 * r["mirostat_tau"] for r in rows], np.float32) \
        + rng.uniform(-2, 2, B).astype(np.float32)
    jsp = _jax_params(rows)
    jtoks, jmu, jfilt, jci = _jax_sample_captured(
        logits, counts, jsp, mu, jax.random.key(seed))
    tsp = tsampling.SamplingParams.from_rows(rows, "cpu")
    tl = tsampling.apply_penalties(torch.from_numpy(logits),
                                   torch.from_numpy(counts), tsp)
    C = min(V, tsampling.N_CANDIDATES)
    vals, cand = torch.topk(tl, C, dim=-1)
    scaled = vals / tsp.temperature.clamp(min=1e-6)[:, None]
    tmu = torch.from_numpy(mu)
    keep = tsampling.mirostat_keep(scaled, tsp, tmu, V)
    jkeep = jfilt > tsampling.NEG_INF / 2
    mir = [b for b, r in enumerate(rows)
           if r["mirostat"] and r["temperature"] > 0]
    assert mir == [0, 1, 2, 3]
    np.testing.assert_array_equal(keep.numpy()[mir], jkeep[mir])
    # v2 and v1 each truncate a slot here (else the test held vacuously)
    for version in ((0, 1), (2, 3)):
        assert any(0 < jkeep[b].sum() < C for b in version)
    filt = torch.where(keep, scaled, torch.full_like(scaled,
                                                     tsampling.NEG_INF))
    probs = tsampling.renormalised(filt)
    np.testing.assert_allclose(
        probs.numpy()[mir], np.asarray(jax.nn.softmax(jfilt[mir], -1)),
        rtol=1e-5, atol=1e-7)
    # the candidates (and so the token JAX drew) are the same
    np.testing.assert_array_equal(
        cand.numpy()[mir, jci[mir]], jtoks[mir])
    mu2 = tsampling.mirostat_update(tmu, probs, torch.from_numpy(
        jci.astype(np.int64)), tsp)
    np.testing.assert_allclose(mu2.numpy()[mir], jmu[mir], rtol=1e-5,
                               atol=1e-5)
    # the other slots' budgets pass through, in both
    rest = [b for b in range(B) if b not in mir]
    np.testing.assert_array_equal(jmu[rest], mu[rest])
    np.testing.assert_array_equal(mu2.numpy()[rest], mu[rest])


def test_port_sample_draws_inside_the_mask_and_moves_mu():
    rng = np.random.default_rng(7)
    rows = _rows()
    B, V = len(rows), 1500
    logits = torch.from_numpy(
        (rng.standard_normal((B, V)) * 3).astype(np.float32))
    counts = torch.zeros((B, V), dtype=torch.int32)
    tsp = tsampling.SamplingParams.from_rows(rows, "cpu")
    mu = torch.full((B,), 9.0)
    gens = [torch.Generator().manual_seed(b) if r["temperature"] > 0
            else None for b, r in enumerate(rows)]
    toks, mu2 = tsampling.sample(logits, counts, tsp, gens, mu)
    vals, cand = torch.topk(tsampling.apply_penalties(logits, counts, tsp),
                            1024, dim=-1)
    scaled = vals / tsp.temperature.clamp(min=1e-6)[:, None]
    keep = tsampling.mirostat_keep(scaled, tsp, mu, V)
    for b in range(4):
        ci = int((cand[b] == toks[b]).nonzero()[0, 0])
        assert keep[b, ci]
        probs = tsampling.renormalised(torch.where(
            keep, scaled, torch.full_like(scaled, tsampling.NEG_INF)))
        want = tsampling.mirostat_update(
            mu, probs, torch.full((B,), ci, dtype=torch.int64), tsp)[b]
        assert float(mu2[b]) == pytest.approx(float(want), rel=1e-6)
    assert float(mu2[4]) == float(mu2[5]) == 9.0
    assert int(toks[5]) == int(torch.argmax(
        tsampling.apply_penalties(logits, counts, tsp)[5]))


@pytest.fixture(scope="module")
def engines():
    jcfg = dataclasses.replace(JPRESETS["tiny"], kernels="interpret")
    tcfg = TPRESETS["tiny"]
    tree = jax.tree_util.tree_map(
        np.asarray, jdec.init_params(jcfg, jax.random.key(3), jnp.float32))
    ecfg = dict(max_slots=4, max_seq_len=64, min_prefill_bucket=16,
                decode_chunk=4)
    jeng = JEngine(jcfg, jax.tree_util.tree_map(jnp.asarray, tree),
                   ecfg=JEngineConfig(paged=False, cache_dtype=jnp.float32,
                                      **ecfg))
    teng = Engine(tcfg, params_from_numpy(tree, device="cpu"),
                  EngineConfig(paged=False, cache_dtype=torch.float32,
                               **ecfg), device="cpu")
    return jeng, teng, tcfg, tree


def test_mu_seeded_at_admission_and_moved_by_live_slots(engines):
    jeng, teng, _, _ = engines
    prompt = np.arange(5, 17)
    kw = dict(mirostat=2, mirostat_tau=3.5, mirostat_eta=0.25,
              repeat_penalty=1.0)
    # greedy mirostat: seeded to 2·tau, nothing moves it
    jeng.admit(0, prompt, JSlotOptions(temperature=0.0, **kw))
    teng.admit(0, prompt, SlotOptions(temperature=0.0, **kw))
    assert float(np.asarray(jeng.mu)[0]) == float(teng.mu[0]) == 7.0
    # sampled mirostat (slot 1) and plain sampling (slot 2)
    teng.admit(1, prompt, SlotOptions(temperature=0.9, seed=4, **kw))
    teng.admit(2, prompt, SlotOptions(temperature=0.9, seed=4))
    mu1 = float(teng.mu[1])
    assert mu1 != 7.0                  # the first token's surprise moved it
    before = teng.mu.clone()
    teng.decode_n_launch(4).wait()
    assert float(teng.mu[0]) == 7.0
    assert float(teng.mu[1]) != mu1
    assert float(teng.mu[2]) == float(before[2])
    assert float(teng.mu[3]) == float(before[3])      # never admitted
    jeng.release(0)
    for s in range(3):
        teng.release(s)


def test_mirostat_work_only_while_a_mirostat_slot_samples(engines):
    """A decode step runs the truncation and the ``mu`` update only while
    an admitted slot samples under mirostat: plain sampled and greedy
    steps skip both and leave every budget as it was."""
    _, teng, _, _ = engines
    prompt = np.arange(3, 15)
    calls = []
    real = tsampling.mirostat_keep

    def counted(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    with mock.patch.object(tsampling, "mirostat_keep", counted):
        teng.admit(0, prompt, SlotOptions(temperature=0.8, seed=2))
        teng.admit(1, prompt, SlotOptions(temperature=0.0, mirostat=1))
        before = teng.mu.clone()
        teng.decode_n_launch(3).wait()
        assert calls == [] and torch.equal(teng.mu, before)
        teng.admit(2, prompt, SlotOptions(temperature=0.8, seed=2,
                                          mirostat=2))
        n = len(calls)
        assert n == 1                       # the first token's draw
        mu2 = float(teng.mu[2])
        teng.decode_n_launch(3).wait()
        assert len(calls) == n + 3 and float(teng.mu[2]) != mu2
        assert torch.equal(teng.mu[:2], before[:2])
        teng.release(2)
        teng.decode_n_launch(2).wait()
        assert len(calls) == n + 3
    for s in range(2):
        teng.release(s)


def test_options_accepted_as_the_reference():
    for req in ({"mirostat": 2, "mirostat_tau": 4.0, "mirostat_eta": 0.2},
                {"mirostat": 1}, {"mirostat": 3}, {"mirostat": "2"}, {}):
        so, _, _ = merge_options({"temperature": 0.5}, req)
        jso, _, _ = jmerge_options({"temperature": 0.5}, req)
        assert dataclasses.asdict(so) == dataclasses.asdict(jso)
    with pytest.raises(JBadRequest) as je:
        jmerge_options({}, {"mirostat": "abc"})
    with pytest.raises(BadRequest) as te:
        merge_options({}, {"mirostat": "abc"})
    assert str(te.value) == str(je.value)


def test_mirostat_requests_served(engines):
    _, _, tcfg, tree = engines
    vocab = {"tokens": [f"<0x{i:02X}>" for i in range(256)],
             "scores": [0.0] * 256, "token_types": [6] * 256,
             "add_bos": False}
    lm = LoadedModel("tiny", tcfg, params_from_numpy(tree, device="cpu"),
                     Tokenizer(model="llama", **vocab), device="cpu",
                     ecfg=EngineConfig(paged=True, max_slots=2,
                                       max_seq_len=128, page_size=16,
                                       min_prefill_bucket=16, decode_chunk=8,
                                       cache_dtype=torch.float32))
    try:
        for mode in (1, 2):
            opts = {"mirostat": mode, "mirostat_tau": 5.0,
                    "mirostat_eta": 0.1, "seed": 11, "temperature": 0.8,
                    "num_predict": 24}
            a = lm.generate("mirostat stream", opts)
            b = lm.generate("mirostat stream", opts)
            assert a.generated_tokens == 24
            assert a.context == b.context
            assert all(0 <= t < tcfg.vocab_size for t in a.context)
    finally:
        lm.unload()


def test_replay_classes_mirostat_nondeterministic():
    for opts, want in (({"mirostat": 1, "temperature": 0.8, "seed": 3},
                        "nondeterministic"),
                       ({"mirostat": 2, "temperature": 0.0},
                        "nondeterministic"),
                       ({"temperature": 0.8, "seed": 3}, None)):
        req = Request([1, 2, 3], SlotOptions(**opts), 4, frozenset())
        jreq = JRequest([1, 2, 3], JSlotOptions(**opts), 4, frozenset())
        assert Scheduler._replay_ineligible(req) == want
        assert JScheduler._replay_ineligible(jreq) == want
