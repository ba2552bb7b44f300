"""Two bf16 faults of the port, held against the JAX function that the
reference's serving path calls, on bf16 inputs on the CPU (an f32 test
cannot see a bf16 rounding, and the card's 3% logit cross-checks cannot
either).

- The tied (or dense) LM head: the JAX ``_unembed`` runs its einsum with
  ``preferred_element_type=float32``, so the logits are the f32 product of
  the bf16 operands. Rounding the product to bf16 first moves every logit
  by up to 2^-9 of its size. Held to 1e-5 x max |logit| with equal argmax.
- The int8 matmul at N <= 16: the JAX package serves int8 weights through
  its XLA ``qmm``, whose decode form at N <= 16 applies the f32 group
  scale after each group's exact dot instead of rounding code x scale to
  bf16. Held to 1e-5 x max |y| at N = 1, 8 and 16, and at N = 17, where
  both sides take the bf16 weight.

And one device fault: the weight makers (``init_params``,
``tensor_from_numpy``, ``params_from_numpy``) defaulted to the CPU where
every other entry point of the port defaults to the card; they now put
weights on the card unless the caller names the CPU, and raise without
CUDA.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu.ops import quant as jquant
from ollama_operator_tpu_torch import convert
from ollama_operator_tpu_torch.models import decoder as tdec
from ollama_operator_tpu_torch.models.config import PRESETS as TPRESETS
from ollama_operator_tpu_torch.ops import quant as tquant

torch.set_num_threads(1)

TIED = dict(dim=256, vocab_size=512, tie_embeddings=True)


def bf16_pair(a):
    """A float array → the same bf16 values as a JAX and a torch array."""
    t = torch.tensor(a).to(torch.bfloat16)
    return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16), t


def test_torch_unembed_tied_f32():
    jcfg = dataclasses.replace(JPRESETS["tiny"], **TIED)
    tcfg = dataclasses.replace(TPRESETS["tiny"], **TIED)
    rng = np.random.default_rng(900)
    D, V = TIED["dim"], TIED["vocab_size"]
    jemb, temb = bf16_pair(rng.standard_normal((V, D)) * 0.1)
    jnw, tnw = bf16_pair(1.0 + 0.1 * rng.standard_normal(D))
    jx, tx = bf16_pair(rng.standard_normal((2, 3, D)))
    j = np.asarray(jdec._unembed(jcfg, {"tok_emb": jemb, "out_norm_w": jnw},
                                 jx))
    t = tdec._unembed(tcfg, {"tok_emb": temb, "out_norm_w": tnw}, tx)
    assert t.dtype == torch.float32 and t.shape == j.shape
    t = t.numpy()
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-5 * np.abs(j).max())
    np.testing.assert_array_equal(t.argmax(-1), j.argmax(-1))


@pytest.mark.parametrize("N", [1, 8, 16, 17])
def test_qmm_small_n_matches_xla_decode_form(N):
    """bf16 x through the port's ``qmm`` against the JAX XLA ``qmm``. At
    N <= 16 the JAX side is fed x as f32 holding the same bf16 values (its
    decode form's products x * code are exact in f32 either way); at
    N = 17 it gets bf16 x, since there it rounds the weight to x's
    dtype."""
    rng = np.random.default_rng(910 + N)
    K, O = 256, 384
    w = rng.standard_normal((K, O)).astype(np.float32) * 0.02
    qw = jquant.quantize_groupwise(w)
    jx, tx = bf16_pair(rng.standard_normal((N, K)))
    if N <= 16:
        jx = jx.astype(jnp.float32)
    j = np.asarray(jquant.qmm(jx, {"q": jnp.asarray(qw["q"]),
                                   "s": jnp.asarray(qw["s"])},
                              out_dtype=jnp.float32))
    t = tquant.qmm(tx, torch.tensor(qw["q"]), torch.tensor(qw["s"]))
    assert t.dtype == torch.float32
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=1e-5 * np.abs(j).max())


@pytest.mark.parametrize("maker", ["init_params", "tensor_from_numpy",
                                   "params_from_numpy"])
def test_weight_makers_default_to_the_card(maker, monkeypatch):
    """With no device named, each weight maker asks for the card and
    raises without CUDA (as every entry point does); with
    ``device="cpu"`` it builds the weights on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = TPRESETS["tiny"]
    arr = np.arange(6, dtype=np.float32).reshape(2, 3)
    make = {
        "init_params": lambda **kw: tdec.init_params(
            cfg, torch.Generator(device="cpu").manual_seed(0),
            torch.float32, **kw)["layers"]["wq"],
        "tensor_from_numpy": lambda **kw: convert.tensor_from_numpy(
            arr, **kw),
        "params_from_numpy": lambda **kw: convert.params_from_numpy(
            {"a": {"b": arr}}, **kw)["a"]["b"]}[maker]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make()
    t = make(device="cpu")
    assert t.device.type == "cpu" and t.dtype == torch.float32
    if maker != "init_params":
        np.testing.assert_array_equal(t.numpy(), arr)
