"""The port's ``ModelManager.load`` against the JAX package's at float32,
on the CPU: both pull the same tiny llama GGUFs (an untied Q4_0 model, and
a tied one with llama3 rope scaling) from ``tests/fake_registry.py`` into
their own stores, load them through the transcode cache, and serve
identical greedy streams, with first-token logits within 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu_torch.models import decoder as tdec
from test_torch_registry import (PARAMS, PROMPTS, _ref,  # noqa: F401
                                 managers, registry)

torch.set_num_threads(1)


def _teacher_logits(dec, lm, ids):
    """Logits at every position of ``ids`` from ``lm``'s served weights
    (a prefill through the package's decoder ``dec``)."""
    toks = np.asarray(ids, np.int64)[None]
    if dec is tdec:
        logits, _, _ = tdec.prefill_chunk(lm.engine.params, lm.cfg,
                                          torch.from_numpy(toks))
        return logits[0].float().numpy()
    logits, _, _ = jdec.prefill_chunk(lm.engine.params, lm.cfg,
                                      jnp.asarray(toks, jnp.int32))
    return np.asarray(logits[0], np.float32)


@pytest.mark.parametrize("model", ["tiny:latest", "tied:q4"])
def test_load_serves_the_jax_streams_f32(managers, registry, model):
    _reg, host = registry
    port, jm = managers()
    ref = _ref(host, model)
    lm, jlm = port.load(ref), jm.load(ref)
    assert lm.name == jlm.name and lm.digest == jlm.digest
    assert lm.serving_dtype == jlm.serving_dtype == "float32"
    assert lm.default_params == jlm.default_params == PARAMS
    assert lm.system == jlm.system
    assert lm.cfg.tie_embeddings == (model == "tied:q4")
    for prompt in PROMPTS:
        got, want = lm.generate(prompt), jlm.generate(prompt)
        assert got.context == want.context
        assert got.generated_tokens == want.generated_tokens == 12
        ids = lm.tokenizer.encode(prompt)
        a = _teacher_logits(tdec, lm, ids)[-1]
        b = _teacher_logits(jdec, jlm, ids)[-1]
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)


