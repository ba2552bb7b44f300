"""Minimal GGUF v3 writer.

A copy of ``ollama_operator_tpu/gguf/writer.py`` that writes the same
bytes. Tests and ``chip_smoke.py`` use it to write GGUF files from a seed.
Two changes let it write a full-size model: string arrays are joined once
(a 128256-piece vocabulary would otherwise be copied once per piece), and
``write`` streams the header and each tensor to the file instead of
building the whole file in memory. Layout matches reader.py's
documentation of the format.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, Tuple

import numpy as np

from . import reader as R


def _pack_string(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _pack_value(v: Any) -> bytes:
    """Infer the GGUF type tag from the python value."""
    if isinstance(v, bool):
        return struct.pack("<I", R.T_BOOL) + struct.pack("<B", int(v))
    if isinstance(v, int):
        if v < 0:
            return struct.pack("<I", R.T_I64) + struct.pack("<q", v)
        return struct.pack("<I", R.T_U32 if v < 2**32 else R.T_U64) + (
            struct.pack("<I", v) if v < 2**32 else struct.pack("<Q", v))
    if isinstance(v, float):
        return struct.pack("<I", R.T_F32) + struct.pack("<f", v)
    if isinstance(v, str):
        return struct.pack("<I", R.T_STR) + _pack_string(v)
    if isinstance(v, (list, tuple, np.ndarray)):
        v = list(v)
        if not v:
            return (struct.pack("<I", R.T_ARR) + struct.pack("<I", R.T_U32) +
                    struct.pack("<Q", 0))
        if isinstance(v[0], str):
            et = R.T_STR
            body = b"".join(_pack_string(e) for e in v)
        elif isinstance(v[0], (float, np.floating)):
            et = R.T_F32
            body = np.asarray(v, np.float32).tobytes()
        else:
            et = R.T_I32
            body = np.asarray(v, np.int32).tobytes()
        return (struct.pack("<I", R.T_ARR) + struct.pack("<I", et) +
                struct.pack("<Q", len(v)) + body)
    raise TypeError(f"cannot encode metadata value {v!r}")


class GGUFWriter:
    def __init__(self, path: str, alignment: int = 32):
        self.path = path
        self.alignment = alignment
        self.metadata: Dict[str, Any] = {"general.alignment": alignment}
        # (name, ne, ggml_type, raw_bytes)
        self._tensors: List[Tuple[str, List[int], int, bytes]] = []

    def add_meta(self, key: str, value: Any):
        self.metadata[key] = value

    def add_tensor_f32(self, name: str, arr: np.ndarray):
        arr = np.ascontiguousarray(arr, np.float32)
        ne = list(reversed(arr.shape))
        self._tensors.append((name, ne, R.GGML_F32, arr.tobytes()))

    def add_tensor_f16(self, name: str, arr: np.ndarray):
        arr = np.ascontiguousarray(arr, np.float16)
        ne = list(reversed(arr.shape))
        self._tensors.append((name, ne, R.GGML_F16, arr.tobytes()))

    def add_tensor_raw(self, name: str, shape: tuple, ggml_type: int,
                       raw: bytes):
        """shape is the numpy row-major shape (reversed into ne)."""
        ne = list(reversed(shape))
        n = int(np.prod(shape))
        assert len(raw) == R.tensor_byte_size(ggml_type, n)
        self._tensors.append((name, ne, ggml_type, raw))

    def write(self):
        head = [R.GGUF_MAGIC, struct.pack("<I", 3),
                struct.pack("<Q", len(self._tensors)),
                struct.pack("<Q", len(self.metadata))]
        for k, v in self.metadata.items():
            head.append(_pack_string(k))
            head.append(_pack_value(v))
        # tensor directory with aligned offsets
        offset = 0
        offsets = []
        for name, ne, t, raw in self._tensors:
            offset = -(-offset // self.alignment) * self.alignment
            offsets.append(offset)
            offset += len(raw)
        for (name, ne, t, raw), off in zip(self._tensors, offsets):
            head.append(_pack_string(name))
            head.append(struct.pack("<I", len(ne)))
            head.extend(struct.pack("<Q", d) for d in ne)
            head.append(struct.pack("<I", t))
            head.append(struct.pack("<Q", off))
        head = b"".join(head)
        with open(self.path, "wb") as f:
            f.write(head)
            f.write(b"\x00" * (-len(head) % self.alignment))
            cur = 0
            for (name, ne, t, raw), off in zip(self._tensors, offsets):
                f.write(b"\x00" * (off - cur))
                f.write(raw)
                cur = off + len(raw)


# ---------------------------------------------------------------------------
# reference quantisers (legacy formats) — used in tests and for int8 export
# ---------------------------------------------------------------------------

def quantize_q8_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1, 32)
    amax = np.abs(x).max(axis=1, keepdims=True)
    d = (amax / 127.0).astype(np.float32)
    inv = np.where(d > 0, 1.0 / np.maximum(d, 1e-30), 0.0)
    q = np.round(x * inv).clip(-127, 127).astype(np.int8)
    blocks = np.concatenate(
        [d.astype(np.float16).view(np.uint8), q.view(np.uint8)], axis=1)
    return blocks.tobytes()


def quantize_q4_0(x: np.ndarray) -> bytes:
    x = np.ascontiguousarray(x, np.float32).reshape(-1, 32)
    # ggml picks the signed max-magnitude value, maps it to -8
    idx = np.abs(x).argmax(axis=1)
    amax = x[np.arange(x.shape[0]), idx]
    d = (amax / -8.0).astype(np.float32)
    inv = np.where(d != 0, 1.0 / np.where(d == 0, 1, d), 0.0)
    q = (x * inv[:, None] + 8.5).clip(0, 15).astype(np.uint8)
    lo, hi = q[:, :16], q[:, 16:]
    qs = lo | (hi << 4)
    blocks = np.concatenate(
        [d.astype(np.float16).view(np.uint8).reshape(-1, 2), qs], axis=1)
    return blocks.tobytes()
