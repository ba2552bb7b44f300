"""Builds the hand-written CUDA kernels under ``csrc/`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and compiles with ``nvcc``
for ``sm_90a`` into its own shared library, loaded through ``ctypes`` (no
PyTorch headers, so a build takes seconds). Libraries go into ``_build/``
beside ``csrc/`` (listed in ``.gitignore``), named by a hash of the source,
of every shared header ``csrc/*.cuh`` and of the flags, so an edited
source or header never loads a stale build. Nothing is
built or imported when this module is imported: the CPU tests import every
module and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"
KERNELS = ("flash_prefill", "paged_decode", "paged_decode_v2",
           "paged_decode_v4", "qmm4", "qmm", "decode_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# kernel -> launches so far; each wrapper adds one where it launches its
# kernel and nowhere else, so a caller can show which kernels a path went
# through (reset by assigning 0). The v3 paged-decode library counts its
# int4 pool variant apart from its int8/bf16 one; the v2 and v4 libraries
# count all three pools; the decode-attention library counts its GQA
# (``decode_attention``) and MHA (``mha_decode``) entries apart.
COUNTERS = ("flash_prefill", "paged_decode", "paged_decode_int4",
            "paged_decode_v2", "paged_decode_v4", "qmm4", "qmm",
            "decode_attention", "mha_decode")
launches: Dict[str, int] = {name: 0 for name in COUNTERS}
_count_lock = threading.Lock()


def count(name: str) -> None:
    """Add one launch of kernel ``name``. Under a lock: an embedding on an
    HTTP thread and the decode loop launch the same kernels at once, and
    ``+=`` on a dict entry is a read and a write that threads can split."""
    with _count_lock:
        launches[name] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels build on a "
                           "machine with the CUDA toolkit")
    return path


def _lib_path(name: str) -> Path:
    """The library of kernel ``name``, tagged by its source, every header
    under ``csrc/`` (any source may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Sequence[str] = KERNELS) -> Dict[str, float]:
    """Compile every missing library among ``names``, one ``nvcc`` per
    source, all started together. Returns {name: seconds} for this call
    (0.0 where the library was already built). Raises with the compiler's
    output when a build fails. The ptxas report (registers, shared
    memory, spills) is kept beside each library as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), tmp, out)
    took = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_bytes(log)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log.decode(errors='replace')}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return took


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory report for ``name``."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text(errors="replace") if log.exists() else ""


def tensor_core_instructions(name: str) -> int:
    """Lines of ``cuobjdump -sass`` of kernel ``name``'s built library that
    are tensor-core instructions (``HMMA``, ``HGMMA``): above 0 when the
    library runs its products on tensor cores."""
    tool = Path(_nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(tool), "-sass", str(_lib_path(name))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    return sum(1 for line in sass.splitlines()
               if "HMMA" in line or "HGMMA" in line)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for kernel ``name``, building it if needed."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
    return lib


_fns: Dict[tuple, object] = {}


def function(name: str, symbol: str, argtypes):
    """The C launcher ``symbol`` of kernel library ``name`` with its
    argument types declared (pointers and the stream as ``c_void_p``, so
    ctypes never narrows them to 32 bits) and an int return code."""
    key = (name, symbol)
    fn = _fns.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def on_card(*tensors) -> bool:
    """False when every tensor lies on the CPU (the caller then runs the
    plain version), True when every tensor lies on the one CUDA device a
    kernel can read; raises for anything else (mixed or other devices),
    so no tensor ever reaches a kernel it cannot be read from."""
    devs = {t.device for t in tensors}
    if all(d.type == "cpu" for d in devs):
        return False
    if len(devs) != 1 or next(iter(devs)).type != "cuda":
        raise ValueError(f"kernel inputs on {sorted(map(str, devs))}: "
                         f"all must be on one CUDA device (or all on the "
                         f"CPU for the plain version)")
    return True


def check(rc: int, what: str) -> None:
    """Raise when a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
