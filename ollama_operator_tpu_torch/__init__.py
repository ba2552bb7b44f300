"""PyTorch + CUDA port of the serving stack, for one NVIDIA H100.

A second package beside ``ollama_operator_tpu`` (the JAX reference, which
stays unchanged). It keeps the JAX package's module names so each
counterpart is easy to find, imports ``torch`` and numpy, and imports
nothing of JAX or of the JAX package: modules it needs that have no JAX in
them (``models/config.py``, ``runtime/paged.py``, ``tokenizer/``,
``server/template.py``) are copies.

Every Pallas kernel on the served path has a hand-written CUDA C++ kernel
for ``sm_90a`` under ``csrc/``, built at first use (``ops/cuda_build.py``)
and bound through ``ctypes``. Beside each kernel's wrapper sits its plain
PyTorch version; a wrapper runs the plain version only for tensors on the
CPU and launches its kernel (or raises) for tensors on the card.

Entry points (``Engine``, ``LoadedModel``, ``ModelManager``, ``serve``)
run on ``device="cuda"`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
