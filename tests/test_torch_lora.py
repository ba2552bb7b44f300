"""Modelfile ``ADAPTER`` in the port (``gguf/lora.py``, merged at load)
against the JAX package, on the CPU.

- ``apply_lora`` gives the JAX ``apply_lora``'s leaves bit for bit on a
  transcoded tiny llama: float32 trees, and bfloat16 trees (the port's
  uint16 patterns against ``ml_dtypes``), over all seven projections, the
  untied head and the embedding; the input tree is left as it was (copy
  on write);
- a model created with ``FROM <store model>`` and ``ADAPTER <file>`` on
  both servers serves the JAX server's greedy tokens, which differ from
  the base model's;
- an adapter with an MoE expert target, one with a bias target, one that
  is not a LoRA GGUF and a file that is no GGUF at all get the
  reference's 400 ("adapter: ...").
"""

import json

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ollama_operator_tpu.gguf import lora as jlora
from ollama_operator_tpu.gguf import transcode as jtc
from ollama_operator_tpu.gguf.reader import GGUFFile as JGGUFFile
from ollama_operator_tpu.models import decoder as jdec
from ollama_operator_tpu.models.config import PRESETS as JPRESETS
from ollama_operator_tpu_torch.gguf import lora as tlora
from ollama_operator_tpu_torch.gguf import transcode as ttc
from ollama_operator_tpu_torch.gguf.reader import GGUFFile
from ollama_operator_tpu_torch.gguf.writer import GGUFWriter
from test_torch_gguf import write_port_gguf
from test_torch_registry import (_call, _json, _ref, managers,  # noqa: F401
                                 registry, servers)

torch.set_num_threads(1)

ALPHA, RANK = 8.0, 4
TARGETS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
           "ffn_up", "ffn_down")


def write_adapter(path, shapes, targets, rng, scale=0.05, arch="llama",
                  adapter_type="lora"):
    """A LoRA GGUF with random A [r, in] / B [out, r] for each target of
    ``shapes`` (GGUF tensor name → (out, in))."""
    w = GGUFWriter(path)
    if arch:
        w.add_meta("general.architecture", arch)
    w.add_meta("general.type", "adapter")
    w.add_meta("adapter.type", adapter_type)
    w.add_meta("adapter.lora.alpha", ALPHA)
    for t in targets:
        out, inn = shapes[t]
        w.add_tensor_f32(t + ".lora_a", (rng.standard_normal(
            (RANK, inn)) * scale).astype(np.float32))
        w.add_tensor_f32(t + ".lora_b", (rng.standard_normal(
            (out, RANK)) * scale).astype(np.float32))
    w.write()
    return path


def all_targets(n_layers):
    return ([f"blk.{i}.{t}.weight" for i in range(n_layers)
             for t in TARGETS] + ["output.weight", "token_embd.weight"])


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    d = tmp_path_factory.mktemp("lora")
    tree = jax.tree_util.tree_map(np.asarray, jdec.init_params(
        JPRESETS["tiny"], jax.random.key(2), jnp.float32))
    path = write_port_gguf(str(d / "base.gguf"), tree)
    with GGUFFile(path) as f:
        shapes = {n: t.shape for n, t in f.tensors.items()}
    adapter = write_adapter(str(d / "adapter.gguf"), shapes,
                            all_targets(JPRESETS["tiny"].n_layers),
                            np.random.default_rng(3))
    return path, adapter, shapes, d


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_apply_lora_bit_equal_to_jax(base, dtype):
    path, adapter, _, _ = base
    with JGGUFFile(path) as f:
        jcfg = jtc.config_from_gguf(f)
        jp = jtc.load_params(f, jcfg, dtype=(ml_dtypes.bfloat16
                                             if dtype == "bfloat16"
                                             else np.float32))
    with GGUFFile(path) as f:
        tcfg = ttc.config_from_gguf(f)
        tp = ttc.load_params(f, tcfg, dtype=dtype)
    before = {k: np.array(v) for k, v in tp["layers"].items()}
    jm = jlora.apply_lora(jp, jcfg, adapter)
    tm = tlora.apply_lora(tp, tcfg, adapter)
    jflat = jax.tree_util.tree_flatten_with_path(jm)[0]
    tflat = dict(jax.tree_util.tree_flatten_with_path(tm)[0])
    assert len(jflat) == len(tflat)
    moved = 0
    for k, v in jflat:
        want = np.asarray(v)
        if dtype == "bfloat16":
            want = want.view(np.uint16)
        assert tflat[k].dtype == want.dtype, k
        np.testing.assert_array_equal(tflat[k], want, err_msg=str(k))
    for k, v in tm["layers"].items():
        moved += int((v != before[k]).any())
        np.testing.assert_array_equal(tp["layers"][k], before[k])
    assert moved == len(TARGETS)


def _both(p, j, *args):
    return _call(p, *args), _call(j, *args)


def test_create_with_adapter_serves_the_jax_tokens(servers, registry, base):
    _reg, host = registry
    _, adapter, _, _ = base
    port, jm, p, j = servers()
    tiny = _ref(host, "tiny")
    mf = f"FROM {tiny}\nADAPTER {adapter}\nPARAMETER temperature 0\n"
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/create",
                               {"model": "tuned:latest", "modelfile": mf,
                                "stream": False})
    assert (s1, _json(t1)) == (s2, _json(t2)) == (200, {"status":
                                                        "success"})
    body = {"prompt": "the adapter changes this", "stream": False,
            "options": {"num_predict": 10, "temperature": 0}}
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/generate",
                               dict(body, model="tuned:latest"))
    assert s1 == s2 == 200
    tuned = _json(t1)["context"]
    assert tuned == _json(t2)["context"]
    (s1, t1), _ = _both(p, j, "POST", "/api/generate",
                        dict(body, model=tiny))
    assert s1 == 200 and _json(t1)["context"] != tuned
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/show",
                               {"model": "tuned:latest"})
    assert "ADAPTER" in _json(t1)["modelfile"]


@pytest.mark.parametrize("case", ["moe", "bias", "not_lora", "junk"])
def test_bad_adapters_refused_as_the_reference(servers, registry, base,
                                               case):
    _reg, host = registry
    path, _, shapes, d = base
    port, jm, p, j = servers()
    rng = np.random.default_rng(4)
    bad = str(d / f"{case}.gguf")
    if case == "moe":
        write_adapter(bad, {"blk.0.ffn_gate_exps.weight": (8, 64)},
                      ["blk.0.ffn_gate_exps.weight"], rng)
    elif case == "bias":
        write_adapter(bad, {"blk.1.attn_q.bias": (64, 64)},
                      ["blk.1.attn_q.bias"], rng)
    elif case == "not_lora":
        write_adapter(bad, shapes, ["blk.0.attn_q.weight"], rng,
                      adapter_type="control_vector")
    else:
        with open(bad, "wb") as f:
            f.write(b"lora bytes")
    mf = f"FROM {_ref(host, 'tiny')}\nADAPTER {bad}\n"
    for srv in (p, j):
        s, t = _call(srv, "POST", "/api/create",
                     {"model": "bad:latest", "modelfile": mf,
                      "stream": False})
        assert s == 200, t
    (s1, t1), (s2, t2) = _both(p, j, "POST", "/api/generate",
                               {"model": "bad:latest", "prompt": "hi",
                                "stream": False})
    a, b = _json(t1)["error"], _json(t2)["error"]
    # the adapter's path in the message is each store's own blob path
    a = a.replace(port.store.root, "STORE")
    b = b.replace(jm.store.root, "STORE")
    assert (s1, a) == (s2, b)
    assert s1 == 400 and a.startswith("adapter: "), a
    assert json.dumps(port.ps()) == "[]"
