"""The port's ``ModelManager.load`` against the JAX package's with an
explicit int8 or int4 weight dtype (``--dtype``), on the CPU: greedy tokens
are equal wherever greedy is decidable (the JAX logits' top-2 gap above
twice the two packages' logit difference at that step).
"""

import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu_torch.models import decoder as tdec
from test_torch_gguf_serving import _teacher_logits
from test_torch_registry import (PROMPTS, _ref, managers,  # noqa: F401
                                 registry)

torch.set_num_threads(1)


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_load_quantized_tokens_equal_where_decidable(managers, registry,
                                                     dtype):
    _reg, host = registry
    port, jm = managers(engine_dtype=dtype)
    ref = _ref(host, "tiny:latest")
    lm, jlm = port.load(ref), jm.load(ref)
    assert lm.serving_dtype == jlm.serving_dtype == dtype
    checked = 0
    for prompt in PROMPTS:
        got, want = lm.generate(prompt), jlm.generate(prompt)
        # teacher-forced logits of both over the reference stream: where
        # the reference's top-2 gap exceeds twice the two packages'
        # difference, greedy is decidable and the tokens must agree
        ctx = want.context
        n_prompt = len(ctx) - want.generated_tokens
        a = _teacher_logits(tdec, lm, ctx[:-1])
        b = _teacher_logits(jdec, jlm, ctx[:-1])
        for k in range(want.generated_tokens):
            pos = n_prompt - 1 + k
            if got.context[n_prompt + k] == ctx[n_prompt + k]:
                checked += 1
                continue
            top2 = np.sort(b[pos])[-2:]
            diff = np.abs(a[pos] - b[pos]).max()
            assert top2[1] - top2[0] <= 2 * diff, (prompt, k)
            break
    assert checked >= 12


