"""Weight-only int8/int4 quantization (W8A16 / W4A16) and the wrappers of
the two dequant-matmul kernels.

Counterpart of ``ollama_operator_tpu/ops/quant.py`` and of the Pallas
``qmm_pallas`` / ``qmm4_pallas`` in ``ops/pallas/quant.py``. A quantized
linear is a dict leaf of the params tree, in the JAX package's layouts:

    int8: {"q":  int8  [..., K,   O], "s": f32 [..., K/32, O]}
    int4: {"q4": uint8 [..., K/2, O], "s": f32 [..., K/32, O]}

symmetric, group-wise along the contracted (input) axis with group 32.
int4 packing is group-local: within each group of 32 rows, byte j holds
row j in its low nibble and row j + 16 in its high nibble, both biased by
+8.

:func:`qmm` / :func:`qmm4` launch ``csrc/qmm.cu`` / ``csrc/qmm4.cu`` for
tensors on the card and run :func:`qmm_plain` / :func:`qmm4_plain` for
tensors on the CPU; :func:`matmul` sends every int8 and int4 matmul
through them, prefill included. With bf16 activations (the card's path)
both compute ``y = sum_k x[k] * bf16(code[k] * s[k/32])`` in f32, as the
TPU kernels do, except the int8 matmul at N <= 16 rows, which takes the
decode form of the JAX package's XLA ``qmm`` (the function it serves
int8 weights with): ``sum_G s[G] * (sum_{k in G} x[k] * code[k])``. With
f32 activations (the CPU tests) the weight stays f32.
"""

from __future__ import annotations

import ctypes
from typing import Any, Dict, Optional, Tuple

import torch

from . import cuda_build

GROUP = 32
# at most this many rows, the JAX package's XLA int8 ``qmm`` takes its
# decode form (the scale after each group's dot); ``csrc/qmm.cu`` switches
# at the same N (its one-tile instantiation, ``qmm_mma_plan``)
DECODE_N = 16

# matmul leaves worth quantizing; tok_emb stays dense (it is a gather)
QUANT_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
QUANT_TOP_KEYS = ("lm_head",)


def is_quantized(w: Any) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w) and "s" in w


def is_int4(w: Any) -> bool:
    return isinstance(w, dict) and "q4" in w


def _per_slice(fn, w: torch.Tensor, out_shapes, out_dtypes):
    """Apply ``fn`` ([K, O] → tuple of tensors) to every [K, O] slice of a
    stacked leaf, writing into preallocated outputs: the f32 temporaries
    stay one slice big, whatever the leaf."""
    *lead, K, O = w.shape
    outs = [torch.empty((*lead, *shp), dtype=dt, device=w.device)
            for shp, dt in zip(out_shapes, out_dtypes)]
    flat_w = w.reshape(-1, K, O)
    flats = [o.reshape(-1, *o.shape[len(lead):]) for o in outs]
    for i in range(flat_w.shape[0]):
        for f, r in zip(flats, fn(flat_w[i])):
            f[i] = r
    return outs


def _quantize_slice(w: torch.Tensor, qmax: int) -> Tuple[torch.Tensor, ...]:
    K, O = w.shape
    wr = w.float().reshape(K // GROUP, GROUP, O)
    s = wr.abs().amax(dim=-2, keepdim=True) / float(qmax)
    q = torch.round(torch.where(s > 0, wr / torch.clamp(s, min=1e-30),
                                torch.zeros((), device=w.device)))
    q = q.clamp(-qmax, qmax).to(torch.int8).reshape(K, O)
    return q, s[:, 0, :]


def quantize_groupwise(w: torch.Tensor, group: int = GROUP
                       ) -> Dict[str, torch.Tensor]:
    """Symmetric int8 per group along the input axis:
    w [..., K, O] → {"q" int8 [..., K, O], "s" f32 [..., K/32, O]}."""
    assert group == GROUP and w.shape[-2] % GROUP == 0, w.shape
    K, O = w.shape[-2:]
    q, s = _per_slice(lambda x: _quantize_slice(x, 127), w,
                      [(K, O), (K // GROUP, O)], [torch.int8, torch.float32])
    return {"q": q, "s": s}


def pack_int4(q: torch.Tensor, bias: int = 8) -> torch.Tensor:
    """Codes in [-7, 7] ([..., K, O]) → group-local nibbles
    ([..., K/2, O] uint8)."""
    *lead, K, O = q.shape
    assert K % GROUP == 0
    qr = (q.reshape(*lead, K // GROUP, GROUP, O).to(torch.int16) + bias
          ).to(torch.uint8)
    lo, hi = qr[..., :GROUP // 2, :], qr[..., GROUP // 2:, :]
    return (lo | (hi << 4)).reshape(*lead, K // 2, O)


def unpack_int4(q4: torch.Tensor, bias: int = 8) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: [..., K/2, O] uint8 → int8
    [..., K, O]."""
    *lead, Kp, O = q4.shape
    h = GROUP // 2
    b = q4.reshape(*lead, Kp // h, h, O)
    lo = (b & 0xF).to(torch.int8) - bias
    hi = (b >> 4).to(torch.int8) - bias
    return torch.cat([lo, hi], dim=-2).reshape(*lead, 2 * Kp, O)


def quantize_groupwise_int4(w: torch.Tensor, group: int = GROUP
                            ) -> Dict[str, torch.Tensor]:
    """Symmetric int4 per group along the input axis, nibble-packed:
    w [..., K, O] → {"q4" uint8 [..., K/2, O], "s" f32 [..., K/32, O]}.
    Codes clip to [-7, 7]."""
    assert group == GROUP and w.shape[-2] % GROUP == 0, w.shape
    K, O = w.shape[-2:]

    def one(x):
        q, s = _quantize_slice(x, 7)
        return pack_int4(q), s

    q4, s = _per_slice(one, w, [(K // 2, O), (K // GROUP, O)],
                       [torch.uint8, torch.float32])
    return {"q4": q4, "s": s}


def dequantize_groupwise(qw: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Inverse of the quantizers (f32)."""
    q = unpack_int4(qw["q4"]) if is_int4(qw) else qw["q"]
    s = qw["s"]
    *lead, K, O = q.shape
    G = s.shape[-2]
    qr = q.reshape(*lead, G, K // G, O).float()
    return (qr * s[..., :, None, :].float()).reshape(*lead, K, O)


def _weight_for(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The dequantized f32 weight as the kernels use it: rounded to bf16
    for bf16 activations (the TPU kernels drop the dequantized tile to the
    compute dtype before the dot), kept in f32 for f32 activations."""
    return w.to(torch.bfloat16).float() if x.dtype == torch.bfloat16 else w


def qmm_plain(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor
              ) -> torch.Tensor:
    """Plain version of the qmm kernel: x [N, K] @ dequant(int8 q [K, O],
    s [K/32, O]) → [N, O] f32, the function the JAX package serves int8
    weights with (its XLA ``qmm``). For bf16 x at N <= 16 that is its
    decode form, ``sum_G s[G] * (sum_{k in G} x[k] * code[k])``: exact
    codes, each group's dot in f32, the f32 scale applied after it.
    Otherwise the weight is code times f32 group scale, rounded to bf16
    when x is bf16, and the product accumulates in f32."""
    N, K = x.shape
    if x.dtype == torch.bfloat16 and N <= DECODE_N:
        G, O = K // GROUP, q.shape[1]
        partial = torch.einsum("nGg,Ggo->nGo",
                               x.float().reshape(N, G, GROUP),
                               q.float().reshape(G, GROUP, O))
        return torch.einsum("nGo,Go->no", partial, s.float())
    return x.float() @ _weight_for(x, dequantize_groupwise({"q": q, "s": s}))


def qmm4_plain(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor
               ) -> torch.Tensor:
    """Plain version of the qmm4 kernel: x [N, K] @ dequant(q4 [K/2, O],
    s [K/32, O]) → [N, O] f32, with the weight formed as in
    :func:`qmm_plain`."""
    return x.float() @ _weight_for(x, dequantize_groupwise({"q4": q4,
                                                           "s": s}))


_TILE_O = 256        # columns per CTA in csrc/qmm.cu and csrc/qmm4.cu
_SMS = 132           # the H100's streaming multiprocessors
_MIN_SPLIT_GROUPS = 8  # K groups a split walks at least


def _mma_plan(N: int, K: int, O: int, mt: int, ctas_per_sm: int
              ) -> Tuple[int, int, int, int]:
    """(16-row tiles a CTA, CTAs down the rows, K splits, groups per
    split) for a tensor-core dequant-matmul kernel with ``mt`` 16-row
    tiles a CTA: as many row blocks as cover N and, when column and row
    tiles alone leave the card underfilled, K split across CTAs (at least
    8 groups a split) as far as the CTAs still fit one wave of
    ``ctas_per_sm`` a SM; a second kernel sums the splits in split
    order."""
    row_blocks = -(-N // (16 * mt))
    ctas = -(-O // _TILE_O) * row_blocks
    target = _SMS * ctas_per_sm
    G = K // GROUP
    ksplit = 1
    if ctas < target:
        ksplit = max(1, min(target // ctas, G // _MIN_SPLIT_GROUPS))
    gps = -(-G // ksplit)
    return mt, row_blocks, -(-G // gps), gps


def qmm4_mma_plan(N: int, K: int, O: int) -> Tuple[int, int, int, int]:
    """The qmm4 kernel's plan (:func:`_mma_plan`): one 16-row tile a CTA
    at N <= 16, two at N <= 32, else four; two CTAs a SM."""
    return _mma_plan(N, K, O, 1 if N <= 16 else 2 if N <= 32 else 4, 2)


def qmm_mma_plan(N: int, K: int, O: int) -> Tuple[int, int, int, int]:
    """The qmm kernel's plan (:func:`_mma_plan`): one 16-row tile a CTA at
    N <= 16 (where the kernel takes the decode form), two at N <= 32,
    four at N <= 64, else eight (128 rows share each dequantized weight,
    so a prefill dequantizes it once per 128 rows). K splits fill one
    CTA a SM: on the H100 that measured faster than two at N = 1, 8 and
    64 (PERF.md section 6)."""
    mt = (1 if N <= DECODE_N else 2 if N <= 32 else 4 if N <= 64 else 8)
    return _mma_plan(N, K, O, mt, 1)


def _launch(name: str, x: torch.Tensor, codes: torch.Tensor,
            s: torch.Tensor, o_multiple: int, plan) -> torch.Tensor:
    """Launch ``csrc/<name>.cu`` for x [N, K] bf16 against one quantized
    [K, O] weight (int8 codes [K, O] or packed uint8 codes [K/2, O]) and
    f32 scales [K/32, O] → [N, O] f32, with the launch shape ``plan(N, K,
    O)`` (ending in K splits and groups per split). Raises on anything the
    kernel does not take: K % 32, O % ``o_multiple``, operands that are
    not 16-byte aligned."""
    N, K = x.shape
    O = codes.shape[1]
    code_dtype, code_rows = ((torch.int8, K) if name == "qmm"
                             else (torch.uint8, K // 2))
    if x.dtype != torch.bfloat16 or codes.dtype != code_dtype or \
            s.dtype != torch.float32:
        raise TypeError(f"{name} kernel takes bf16 x, {code_dtype} codes, "
                        f"f32 scales; got {x.dtype}, {codes.dtype}, "
                        f"{s.dtype}")
    if (N < 1 or O < 1 or codes.shape[0] != code_rows or K % GROUP
            or O % o_multiple or s.shape != (K // GROUP, O)):
        raise ValueError(f"{name} kernel: x {tuple(x.shape)}, codes "
                         f"{tuple(codes.shape)}, s {tuple(s.shape)} "
                         f"unsupported")
    x, codes, s = x.contiguous(), codes.contiguous(), s.contiguous()
    if any(t.data_ptr() % 16 for t in (x, codes, s)):
        raise ValueError(f"{name} kernel: operands must be 16-byte aligned")
    shape = plan(N, K, O)
    ksplit = shape[-2]
    out = torch.empty((N, O), dtype=torch.float32, device=x.device)
    work = (torch.empty((ksplit, N, O), dtype=torch.float32,
                        device=x.device) if ksplit > 1 else out)
    fn = cuda_build.function(
        name, f"{name}_bf16", [ctypes.c_void_p] * 5
        + [ctypes.c_int] * (3 + len(shape)) + [ctypes.c_void_p])
    rc = fn(x.data_ptr(), codes.data_ptr(), s.data_ptr(), out.data_ptr(),
            work.data_ptr(), N, K, O, *shape,
            torch.cuda.current_stream().cuda_stream)
    cuda_build.check(rc, name)
    cuda_build.count(name)
    return out


def qmm(x: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """x [N, K] @ dequant(int8 q [K, O], s [K/32, O]) → [N, O] f32, the
    function of :func:`qmm_plain` (the decode form at N <= 16 for bf16 x).

    On the card this launches ``csrc/qmm.cu`` (x bf16, K % 32 == 0,
    O % 16 == 0: its 16-byte copies of code rows) for every N and raises
    on anything it does not take; on the CPU it runs :func:`qmm_plain`."""
    if not cuda_build.on_card(x, q, s):
        return qmm_plain(x, q, s)
    return _launch("qmm", x, q, s, 16, qmm_mma_plan)


def qmm4(x: torch.Tensor, q4: torch.Tensor, s: torch.Tensor
         ) -> torch.Tensor:
    """x [N, K] @ dequant(q4 [K/2, O], s [K/32, O]) → [N, O] f32.

    On the card this launches ``csrc/qmm4.cu`` (x bf16, K % 32 == 0,
    O % 16 == 0) for every N and raises on anything it does not take; on
    the CPU it runs :func:`qmm4_plain`."""
    if not cuda_build.on_card(x, q4, s):
        return qmm4_plain(x, q4, s)
    return _launch("qmm4", x, q4, s, 16, qmm4_mma_plan)


def matmul(x: torch.Tensor, w: Any,
           out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Linear against a dense tensor or a quantized dict leaf. Every int4
    matmul goes through :func:`qmm4` and every int8 matmul through
    :func:`qmm` (the kernels on the card), whatever the token count."""
    if not is_quantized(w):
        y = x @ w
        return y.to(out_dtype) if out_dtype is not None else y
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    y = (qmm4(x2, w["q4"], w["s"]) if is_int4(w)
         else qmm(x2, w["q"], w["s"]))
    return y.reshape(*lead, -1).to(out_dtype or x.dtype)


def quantize_params(params: Dict[str, Any], bits: int = 4,
                    keys_layer=QUANT_LAYER_KEYS,
                    keys_top=QUANT_TOP_KEYS) -> Dict[str, Any]:
    """Quantize the big matmul leaves of a decoder params tree to int8
    (``bits=8``) or packed int4 (``bits=4``). Leaves are popped from
    ``params`` one at a time, so each dense leaf can be freed as soon as
    its quantized replacement exists (peak memory: the dense tree plus
    one slice's f32 temporaries)."""
    assert bits in (8, 4), bits
    quant = quantize_groupwise if bits == 8 else quantize_groupwise_int4
    out: Dict[str, Any] = {}
    for k in list(params.keys()):
        v = params[k]
        if k == "layers":
            lo = {}
            for lk in list(v.keys()):
                lo[lk] = quant(v.pop(lk)) if lk in keys_layer else v[lk]
            out[k] = lo
        elif k in keys_top:
            out[k] = quant(params.pop(k))
        else:
            out[k] = v
    return out
