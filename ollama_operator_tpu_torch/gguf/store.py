"""Transcoded-weights cache: ``TensorStoreWriter`` and ``TensorStore``.

A copy of those two classes of ``ollama_operator_tpu/gguf/store.py``, with
the same files: one ``weights.bin`` (64-byte-aligned concatenated tensors,
mmap-able) plus an ``index.json`` {name → dtype, shape, offset}. So a cache
written by either package is read by the other. Re-serving a model is then
a memmap and a copy to the card, not a re-dequantization.

dtypes: "f32", "f16", "bf16", "i8", "i32". The port has no bfloat16 numpy
type: a bf16 tensor is a uint16 array of its bit patterns, written and read
as such (``convert.tensor_from_numpy`` takes uint16 arrays as bf16).
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterator, Tuple

import numpy as np

ALIGN = 64

_DTYPES = {
    "f32": np.float32,
    "f16": np.float16,
    "bf16": np.uint16,
    "i8": np.int8,
    "i32": np.int32,
}
_NAMES = {np.dtype(v): k for k, v in _DTYPES.items()}


def dtype_name(dt) -> str:
    return _NAMES[np.dtype(dt)]


class TensorStoreWriter:
    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self.path = path
        # unique tmp names: concurrent transcodes into a shared store (two
        # replicas racing on one volume) each write their own file;
        # os.replace makes the last finisher win atomically
        self._tmp_suffix = f".tmp.{os.getpid()}.{os.urandom(4).hex()}"
        self._bin = open(os.path.join(path, "weights.bin" + self._tmp_suffix),
                         "wb")
        self._index: Dict[str, dict] = {}
        self._meta: Dict[str, object] = {}

    def add_meta(self, key: str, value):
        self._meta[key] = value

    def add(self, name: str, arr: np.ndarray):
        arr = np.ascontiguousarray(arr)
        pos = self._bin.tell()
        pad = -pos % ALIGN
        self._bin.write(b"\x00" * pad)
        off = pos + pad
        self._bin.write(memoryview(arr).cast("B"))
        self._index[name] = {"dtype": dtype_name(arr.dtype),
                             "shape": list(arr.shape), "offset": off}

    def finish(self):
        self._bin.close()
        os.replace(os.path.join(self.path, "weights.bin" + self._tmp_suffix),
                   os.path.join(self.path, "weights.bin"))
        tmp = os.path.join(self.path, "index.json" + self._tmp_suffix)
        with open(tmp, "w") as f:
            json.dump({"meta": self._meta, "tensors": self._index}, f)
        os.replace(tmp, os.path.join(self.path, "index.json"))


class TensorStore:
    """Read side; zero-copy views into one mmap'd file."""

    def __init__(self, path: str):
        self.path = path
        with open(os.path.join(path, "index.json")) as f:
            idx = json.load(f)
        self.meta: Dict[str, object] = idx["meta"]
        self._index = idx["tensors"]
        self._mm = np.memmap(os.path.join(path, "weights.bin"),
                             np.uint8, mode="r")

    @staticmethod
    def exists(path: str) -> bool:
        return (os.path.exists(os.path.join(path, "index.json"))
                and os.path.exists(os.path.join(path, "weights.bin")))

    def names(self):
        return list(self._index)

    def get(self, name: str) -> np.ndarray:
        e = self._index[name]
        dt = np.dtype(_DTYPES[e["dtype"]])
        n = int(np.prod(e["shape"])) if e["shape"] else 1
        raw = self._mm[e["offset"]: e["offset"] + n * dt.itemsize]
        return raw.view(dt).reshape(e["shape"])

    def items(self) -> Iterator[Tuple[str, np.ndarray]]:
        for name in self._index:
            yield name, self.get(name)
