"""LoRA adapter merging: the Modelfile ``ADAPTER`` directive.

A copy of ``ollama_operator_tpu/gguf/lora.py``. The adapter is merged at
load time, W' = W + (alpha/r)·(B@A), on the host in numpy, in the
transcoded layout (weights [in, out], the q/k rope rows un-permuted for
the interleaved-rope arches), before the weights are quantized: serving
then runs the same dequant matmuls as the base model, with no cost a
token.

Adapter format: a GGUF (llama.cpp's ``convert_lora_to_gguf``) with
``adapter.lora.alpha`` metadata and tensor pairs ``<base>.lora_a`` [r, in]
/ ``<base>.lora_b`` [out, r] named after the base model's tensors
(blk.N.attn_q.weight, ...).

The tree's leaves are float32 arrays or, for bfloat16, uint16 arrays of
the bf16 bit patterns (``gguf/transcode.py``). A bf16 leaf takes the
delta as the JAX package's ``ml_dtypes`` add takes it: the delta rounded
to bf16, both widened to f32, the f32 sum rounded to nearest even.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict

import numpy as np
import torch

from . import dequant as DQ
from .reader import GGUFFile
from .transcode import _INTERLEAVED_ROPE_ARCHES, _unpermute_rope


def _dq32(f: GGUFFile, name: str) -> np.ndarray:
    return np.asarray(DQ.dequantize_tensor(f, f.tensors[name]), np.float32)


def _add(arr: np.ndarray, i, delta: np.ndarray):
    """arr[i] += delta in arr's dtype (float32, or bf16 as uint16), in
    place (``arr`` is the merge's own copy). A bf16 leaf adds in torch,
    on every host core: the delta rounded to bf16, then torch's bf16 add,
    which widens both to f32 (exact) and rounds the f32 sum to nearest
    even."""
    if arr.dtype == np.uint16:
        w = torch.from_numpy(arr[i].view(np.int16)).view(torch.bfloat16)
        w.add_(torch.from_numpy(delta).to(
            torch.bfloat16, memory_format=torch.contiguous_format))
    else:
        arr[i] += delta.astype(arr.dtype)


def _targets(cfg):
    """base GGUF tensor suffix → (param key, delta post-transform): the
    GGUF-layout delta [out, in] into the transcoded layout."""
    H, KvH = cfg.n_heads, cfg.n_kv_heads

    def T_(a):
        return a.T
    return {
        "attn_q.weight": ("wq", lambda a: _unpermute_rope(a, H).T),
        "attn_k.weight": ("wk", lambda a: _unpermute_rope(a, KvH).T),
        "attn_v.weight": ("wv", T_),
        "attn_output.weight": ("wo", T_),
        "ffn_up.weight": ("w_up", T_),
        "ffn_down.weight": ("w_down", T_),
        "ffn_gate.weight": ("w_gate", T_),
    }


def apply_lora(params: Dict[str, Any], cfg, adapter_path: str
               ) -> Dict[str, Any]:
    """Merge a GGUF LoRA adapter into the (numpy, host-side) param tree.

    Returns the same tree with the touched leaves replaced (copy on
    write: the transcode cache's memory maps are never written through).
    Raises ValueError for an adapter that targets tensors this model does
    not have, or that merging does not take (MoE experts, biases)."""
    with GGUFFile(adapter_path) as f:
        if f.metadata.get("adapter.type", "lora") != "lora":
            raise ValueError(f"{adapter_path}: adapter.type "
                             f"{f.metadata.get('adapter.type')!r} is not "
                             f"a LoRA adapter")
        alpha = float(f.metadata.get("adapter.lora.alpha", 16.0))
        names = [n for n in f.tensors if n.endswith(".lora_a")]
        if not names:
            raise ValueError(f"{adapter_path}: no .lora_a tensors — not a "
                             f"LoRA adapter GGUF")
        targets = _targets(cfg)
        # the converter writes q/k in the base arch's layout: the
        # interleaved-rope family needs the base weights' un-permutation.
        # An adapter often names no architecture: the base model's raw
        # GGUF arch decides then (qwen2 and gemma normalise to "llama"
        # but are not interleaved)
        arch = (f.metadata.get("general.architecture")
                or cfg.gguf_arch or cfg.arch)
        if arch not in _INTERLEAVED_ROPE_ARCHES:
            targets["attn_q.weight"] = ("wq", lambda a: a.T)
            targets["attn_k.weight"] = ("wk", lambda a: a.T)
        layers = dict(params["layers"])
        copied = set()
        out = dict(params)
        # every target is checked (and its leaf copied) before any delta
        # is made; the deltas then run on a few threads (numpy's product
        # and torch's add release the GIL), each into its own slice
        jobs = []
        for name in sorted(names):
            base = name[: -len(".lora_a")]
            b_name = base + ".lora_b"
            if b_name not in f.tensors:
                raise ValueError(f"{adapter_path}: {name} has no matching "
                                 f".lora_b")
            A = _dq32(f, name)       # [r, in]
            B = _dq32(f, b_name)     # [out, r]
            if A.shape[0] != B.shape[1]:
                # tolerate transposed dumps
                if A.shape[1] == B.shape[1]:
                    A = A.T
                elif A.shape[0] == B.shape[0]:
                    B = B.T
                else:
                    raise ValueError(
                        f"{adapter_path}: rank mismatch {name} {A.shape} "
                        f"vs {b_name} {B.shape}")
            shape = (B.shape[0], A.shape[1])          # the delta, [out, in]

            if base == "token_embd.weight":
                if shape != params["tok_emb"].shape:
                    raise ValueError(f"{adapter_path}: token_embd delta "
                                     f"{shape} vs "
                                     f"{params['tok_emb'].shape}")
                if "tok_emb" not in copied:
                    out["tok_emb"] = np.array(out["tok_emb"])
                    copied.add("tok_emb")
                jobs.append((out["tok_emb"], slice(None), A, B,
                             lambda a: a))
                continue
            if base == "output.weight":
                if "lm_head" not in params:
                    raise ValueError(f"{adapter_path}: adapter targets "
                                     f"output.weight but the model ties "
                                     f"embeddings")
                if "lm_head" not in copied:
                    out["lm_head"] = np.array(out["lm_head"])
                    copied.add("lm_head")
                jobs.append((out["lm_head"], slice(None), A, B,
                             lambda a: a.T))
                continue

            if not base.startswith("blk."):
                raise ValueError(f"{adapter_path}: unsupported LoRA target "
                                 f"{base!r}")
            _, idx, suffix = base.split(".", 2)
            i = int(idx)
            tgt = targets.get(suffix)
            if tgt is None:
                raise ValueError(f"{adapter_path}: unsupported LoRA target "
                                 f"{base!r} (MoE expert and bias adapters "
                                 f"are not mergeable here)")
            key, post = tgt
            if key not in layers or layers[key] is None:
                raise ValueError(f"{adapter_path}: adapter targets {base!r} "
                                 f"but the model has no {key!r}")
            if "layers/" + key not in copied:
                layers[key] = np.array(layers[key])  # [L, in, out] copy
                copied.add("layers/" + key)
            if shape[::-1] != layers[key][i].shape:
                raise ValueError(f"{adapter_path}: delta for {base} is "
                                 f"{shape[::-1]}, model expects "
                                 f"{layers[key][i].shape}")
            jobs.append((layers[key], i, A, B, post))

        def merge(job):
            dst, i, A, B, post = job
            delta = (alpha / A.shape[0]) * (B @ A)    # [out, in]
            _add(dst, i, post(delta))
        with ThreadPoolExecutor(4) as pool:
            list(pool.map(merge, jobs))
        out["layers"] = layers
        return out
