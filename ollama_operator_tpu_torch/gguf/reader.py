"""GGUF container parser (v2/v3, little-endian), zero-copy via mmap.

A copy of ``ollama_operator_tpu/gguf/reader.py`` (the torch port keeps its
own copy and imports nothing of the JAX package). It feeds the dequantizer
(gguf/dequant.py) and the transcoder (gguf/transcode.py), which produce the
numpy tree that ``convert.params_from_numpy`` carries to the card.

Format (little-endian):
  magic "GGUF" | version u32 | n_tensors u64 | n_kv u64
  n_kv × (key: string, value_type: u32, value)
  n_tensors × (name: string, n_dims: u32, dims u64×n (ne order: dims[0] is
               the contiguous/innermost axis), ggml_type u32, offset u64)
  padding to `general.alignment` (default 32)
  tensor data (each tensor at its offset from the start of the data section)

string = u64 length + utf-8 bytes. Array values = elem_type u32 + count u64 +
elements.
"""

from __future__ import annotations

import dataclasses
import mmap
import struct
from typing import Any, BinaryIO, Dict, List, Optional

import numpy as np

GGUF_MAGIC = b"GGUF"

# metadata value types
T_U8, T_I8, T_U16, T_I16, T_U32, T_I32, T_F32, T_BOOL, T_STR, T_ARR, \
    T_U64, T_I64, T_F64 = range(13)

_SCALAR_FMT = {T_U8: "<B", T_I8: "<b", T_U16: "<H", T_I16: "<h",
               T_U32: "<I", T_I32: "<i", T_F32: "<f", T_U64: "<Q",
               T_I64: "<q", T_F64: "<d"}

# ggml tensor dtypes (subset we support; ids from the ggml type enum)
GGML_F32, GGML_F16 = 0, 1
GGML_Q4_0, GGML_Q4_1 = 2, 3
GGML_Q5_0, GGML_Q5_1 = 6, 7
GGML_Q8_0, GGML_Q8_1 = 8, 9
GGML_Q2_K, GGML_Q3_K, GGML_Q4_K, GGML_Q5_K, GGML_Q6_K, GGML_Q8_K = \
    10, 11, 12, 13, 14, 15
GGML_I8, GGML_I16, GGML_I32 = 24, 25, 26
GGML_BF16 = 30
# importance-matrix ("i-quant") family; the 4-bit non-linear pair is the
# common one in modern registry tags (iq4_nl blocks like q4_0, iq4_xs
# k-quant-style super-blocks, both through the same non-linear LUT)
GGML_IQ4_NL, GGML_IQ4_XS = 20, 23
# codebook i-quants: named so unsupported-type errors are readable
# (decode needs llama.cpp's searched grid tables — see gguf/dequant.py)
GGML_IQ2_XXS, GGML_IQ2_XS, GGML_IQ3_XXS, GGML_IQ1_S = 16, 17, 18, 19
GGML_IQ3_S, GGML_IQ2_S, GGML_IQ1_M = 21, 22, 29

GGML_TYPE_NAMES = {
    GGML_F32: "F32", GGML_F16: "F16", GGML_BF16: "BF16",
    GGML_Q4_0: "Q4_0", GGML_Q4_1: "Q4_1", GGML_Q5_0: "Q5_0",
    GGML_Q5_1: "Q5_1", GGML_Q8_0: "Q8_0",
    GGML_Q2_K: "Q2_K", GGML_Q3_K: "Q3_K", GGML_Q4_K: "Q4_K",
    GGML_Q5_K: "Q5_K", GGML_Q6_K: "Q6_K",
    GGML_I8: "I8", GGML_I16: "I16", GGML_I32: "I32",
    GGML_IQ4_NL: "IQ4_NL", GGML_IQ4_XS: "IQ4_XS",
    GGML_IQ2_XXS: "IQ2_XXS", GGML_IQ2_XS: "IQ2_XS",
    GGML_IQ3_XXS: "IQ3_XXS", GGML_IQ1_S: "IQ1_S",
    GGML_IQ3_S: "IQ3_S", GGML_IQ2_S: "IQ2_S", GGML_IQ1_M: "IQ1_M",
}

# (block_elems, block_bytes) per quantised type
BLOCK_LAYOUT = {
    GGML_F32: (1, 4), GGML_F16: (1, 2), GGML_BF16: (1, 2),
    GGML_I8: (1, 1), GGML_I16: (1, 2), GGML_I32: (1, 4),
    GGML_Q4_0: (32, 18), GGML_Q4_1: (32, 20),
    GGML_Q5_0: (32, 22), GGML_Q5_1: (32, 24), GGML_Q8_0: (32, 34),
    GGML_Q2_K: (256, 84), GGML_Q3_K: (256, 110), GGML_Q4_K: (256, 144),
    GGML_Q5_K: (256, 176), GGML_Q6_K: (256, 210),
    GGML_IQ4_NL: (32, 18), GGML_IQ4_XS: (256, 136),
}


def tensor_byte_size(ggml_type: int, n_elems: int) -> int:
    be, bb = BLOCK_LAYOUT[ggml_type]
    assert n_elems % be == 0, (ggml_type, n_elems)
    return n_elems // be * bb


@dataclasses.dataclass
class GGUFTensor:
    name: str
    ggml_type: int
    ne: List[int]            # ggml order: ne[0] innermost/contiguous
    offset: int              # relative to data section start

    @property
    def n_elems(self) -> int:
        n = 1
        for d in self.ne:
            n *= d
        return n

    @property
    def shape(self) -> tuple:
        """Row-major numpy shape: reversed ne — e.g. a linear weight is
        (out_features, in_features)."""
        return tuple(reversed(self.ne))

    @property
    def nbytes(self) -> int:
        return tensor_byte_size(self.ggml_type, self.n_elems)

    @property
    def type_name(self) -> str:
        return GGML_TYPE_NAMES.get(self.ggml_type, f"?{self.ggml_type}")


class _Cursor:
    def __init__(self, buf, pos=0):
        self.buf = buf
        self.pos = pos

    def read(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise EOFError("truncated GGUF file")
        self.pos += n
        return b

    def scalar(self, t: int):
        fmt = _SCALAR_FMT[t]
        v = struct.unpack(fmt, self.read(struct.calcsize(fmt)))[0]
        return v

    def string(self) -> str:
        n = self.scalar(T_U64)
        return self.read(n).decode("utf-8", errors="replace")

    def value(self, t: int):
        if t == T_BOOL:
            return bool(self.read(1)[0])
        if t == T_STR:
            return self.string()
        if t == T_ARR:
            et = self.scalar(T_U32)
            n = self.scalar(T_U64)
            return [self.value(et) for _ in range(n)]
        return self.scalar(t)


class GGUFFile:
    """Parsed GGUF: metadata dict + tensor directory + mmap'd data."""

    def __init__(self, path: str):
        self.path = path
        self._f: BinaryIO = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        cur = _Cursor(self._mm)
        if cur.read(4) != GGUF_MAGIC:
            raise ValueError(f"{path}: not a GGUF file")
        self.version = cur.scalar(T_U32)
        if self.version not in (2, 3):
            raise ValueError(f"{path}: unsupported GGUF version {self.version}")
        n_tensors = cur.scalar(T_U64)
        n_kv = cur.scalar(T_U64)
        self.metadata: Dict[str, Any] = {}
        for _ in range(n_kv):
            key = cur.string()
            t = cur.scalar(T_U32)
            self.metadata[key] = cur.value(t)
        self.tensors: Dict[str, GGUFTensor] = {}
        for _ in range(n_tensors):
            name = cur.string()
            n_dims = cur.scalar(T_U32)
            ne = [cur.scalar(T_U64) for _ in range(n_dims)]
            ggml_type = cur.scalar(T_U32)
            offset = cur.scalar(T_U64)
            self.tensors[name] = GGUFTensor(name, ggml_type, ne, offset)
        align = int(self.metadata.get("general.alignment", 32))
        self.data_start = (cur.pos + align - 1) // align * align

    # -- access -----------------------------------------------------------
    def raw(self, t: GGUFTensor) -> np.ndarray:
        """Raw quantised bytes of a tensor (zero-copy view into the mmap)."""
        start = self.data_start + t.offset
        return np.frombuffer(self._mm, np.uint8, t.nbytes, start)

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()

    # -- conveniences -----------------------------------------------------
    @property
    def arch(self) -> str:
        return self.metadata.get("general.architecture", "unknown")

    def field(self, suffix: str, default=None):
        """Look up '<arch>.<suffix>' (the usual key shape)."""
        return self.metadata.get(f"{self.arch}.{suffix}", default)
