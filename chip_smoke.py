#!/usr/bin/env python3
"""Drive the torch port (``ollama_operator_tpu_torch``) on one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and build the seven CUDA kernel libraries from ``csrc/``
   (one ``nvcc`` per source, all started together); print each library's
   tensor-core instruction count (``HMMA``/``HGMMA`` lines of
   ``cuobjdump -sass``), which must be above 0 for the flash-prefill,
   qmm4, qmm, decode-attention and the three paged-decode (v3, v2, v4)
   libraries; the qmm, decode-attention and paged-decode kernels must not
   spill registers, and the paged kernels must take their tensor-core path
   at the served head dims (128 and 96).
2. Kernel phases at the main paths' shapes, in bf16 on the card: each
   kernel against its plain PyTorch version on the same inputs, with the
   tolerance stated beside it (attention kernels: every query row or slot
   within 1% of its own largest output, the worst one printed, and the
   share of bf16 outputs not bit-equal to the plain version's); the
   kernel's time (CUDA events, L2 flushed before every launch, as a
   decode step finds it, the host's launch work kept out of the window),
   the plain version's time, the time of one PyTorch library call
   computing the same function where one exists, and the least time the
   card could take (bytes at 3.35 TB/s or bf16 operations at 989
   TFLOP/s, whichever is larger).
   Kernels: flash prefill (also at phi3's MHA shape, hd 96, window 2047, and
   at two ragged chunks, one with hd 80, a window and a softcap); the three
   paged-decode kernels (K6 v3, K4 v2, K5 v4) over int8, int4 and bf16
   pools, at phi3's G = 1, hd 96 (int8 and bf16), and with nblk below the
   longest slot's live pages; at a decode step of the serving paths (8
   slots at 180..300 positions: K6 and K4 at H = 32, K6 at H = 24 and on
   an int4 pool, K6 and K5 at phi3's G = 1), the same step with every slot
   of the engine's table (64, phi3 32; the idle ones at length 0; K6 and
   K4, K6 and K5); K6 at the chunks of 256 and 1024 positions beside its
   512, K4 at one page a CTA, K5 at 2048 and 8192 CTAs beside its 4096.
   Every paged row is checked bit-identical over two launches and read for
   the wrapper's host time a call (with ``--baseline DIR``, a checkout of
   another commit, that commit's kernel of the same route timed beside it,
   and its K6 output required bit-equal to this one's); the
   GQA (K2) and MHA (K3) decode kernels over the dense slot cache (K2 also
   at the serving lengths and at other head dims, a full group and a
   softcap, and both at other sequence chunks than their wrappers'); the
   int4 (qmm4, llama3.1 shapes) and int8 (qmm, llama3.2:3b shapes, N = 8
   among them, where qmm takes the decode form, and N = 17, the first past
   it; phi3's LM head, O = 32064, and a second ragged O) dequant matmuls.
   Also the tied LM head's f32 product (a bf16 GEMM with an f32 output)
   against the f32 product of the same values.
3. Serving, eight paths, each at full width behind the port's HTTP
   server on an ephemeral port (path 1 at full depth, paths 2-8 cut to 8
   layers, ``SERVING_LAYERS``: path 9 serves path 2's model and cache at
   full depth), with random dense bf16 weights from a seed handed to
   ``ModelManager.preload``, which picks the weight dtype itself (int4
   for llama3.1, int8 for llama3.2:3b and phi3; a cut path is given the
   dtype its full depth resolves to), and
   the serving defaults for the cache kind it is told (``SERVING``):
   paged (GQA: 64 slots, page size 128, 768 pages; phi3: 32 slots, page
   size 64, 512 pages) — llama3.1 on an int8 pool, llama3.2:3b on an int8
   and on an int4 pool, phi3 on an int8 pool — then dense (8 slots of
   4096 rows, bf16) — llama3.2:3b through the GQA decode kernel, phi3 with
   ``TPU_MHA_KERNEL=1`` through the MHA decode kernel — then paged again:
   llama3.1 on an int8 pool with ``TPU_PAGED_V3=0`` (K4) and phi3 on an
   int8 pool with ``TPU_PAGED_V4=1`` (K5); decode chunk 32.
   Each: the paged-decode route the knobs pick must be the path's, eight
   concurrent /api/generate requests (prompts of 96 to 316 tokens,
   num_predict 32, greedy) must each finish with eval_count 32, two
   repeats of one prompt (each extends the prefix the first run left in
   the radix tree, or in its parked slot on the dense cache) must reuse a
   prefix and give the same tokens (how many match the cold run's is
   printed), and the launch count of every kernel on that path, counted
   from 0 just before the eight requests, must be above 0 (and the other
   decode kernels' 0). Path 1 stays loaded for phase 5.
4. Cross-checks at full width and two layers: llama3.1 int4 on an int8
   pool, llama3.2:3b int8 on an int4 pool, llama3.2:3b int8 on a bf16
   dense cache (K2), phi3 int8 on a bf16 dense cache (K3), llama3.1 int4
   on an int8 pool under ``TPU_PAGED_V3=0`` (K4) and phi3 int8 on an int8
   pool under ``TPU_PAGED_V4=1`` (K5): the kernel path against the plain
   path on the card, a prefill and 16 greedy decode steps, the plain path
   fed the kernel path's tokens. Logits must agree within the stated bf16
   tolerance at every step, and the greedy tokens must be identical at
   every step where greedy is decidable (top-2 gap above twice the step's
   logit difference; near-ties are listed).
5. Prefix reuse and chunked prefill on path 1's model at the serving
   defaults (``prefix_phase``): a 1000-token prefix shared by 8 concurrent
   requests after a warm one (each must reuse >= 1000 tokens; two
   repeats of one must agree), and a 3000-token prompt admitted in 12
   pieces of 256 with a decode dispatch between each two while 4 slots
   decode (the flash-prefill, paged-decode and qmm4 counters above 0).
   Then path 1's decode step is timed and it is unloaded.
6. Prefix cross-checks at full width and two layers, through the engine's
   calls (``prefix_cross_check``): a stitched extend (7 shared pages and a
   copied boundary page) against the same tail over a parked cold prefix
   and against a cold admission, and 12 pieces of 256 against 3 pieces
   and against one shot, on llama3.1 int4 over an int8 pool, on
   llama3.2:3b int8 over an int4 pool with an odd boundary, and on
   llama3.1 over a bf16 pool; logits within 3% of max |logit|, tokens
   equal where greedy is decidable, the shared pages unchanged. The
   pairs against a cold or one-shot admission compare an extend, which
   attends the pool's rounded K/V, with a prefill over exact K/V: gates
   on the int8 and bf16 pools, reported on the int4 pool.

7. Path 9, a model pulled into the blob store from a GGUF file and served
   by the port's own processes (``gguf_phase``): llama3.2:3b at full width
   and depth written as a GGUF from the seed, one tensor at a time (Q4_0
   layer weights, a Q8_0 ``token_embd`` that is also the tied head, F32
   norms, llama3 rope scaling as a ``rope_freqs`` tensor, a 128256-piece
   ``llama`` vocabulary with byte fallback); a loopback registry of this
   script's own serves its manifest and streams the blob from disk;
   ``python -m ollama_operator_tpu_torch.server --store-only`` and the
   pull CLI (``python -m ollama_operator_tpu_torch.server.pull`` against
   ``$OLLAMA_HOST``) pull it into a store; ``python -m
   ollama_operator_tpu_torch.server --preload`` reads, dequantizes and
   transcodes it (cached under ``--cache``) and serves it with int8
   weights resolved per model (K7) on an int8 paged pool (K6) with K1;
   8 concurrent greedy requests, the kernels' launch counts read from the
   server's ``/api/ps`` just before and just after them (flash_prefill,
   paged_decode and qmm above 0, the others 0). Then the model server is
   started again and loads from the transcode cache (the cache file must
   not be rewritten), and its greedy streams for the 8 prompts, one at a
   time, must equal those of ``ModelManager.preload`` in this process of
   the tree the port's ``load_model`` gives for the same blob and cache,
   at int8 with the server's engine settings. The time to pull, to start
   and load with the transcode and from the cache, the server's host
   memory and bytes on the card after each load, TTFT and tok/s are
   printed beside the card's name and power limit.

Then it prints one JSON line ``{"kernels": [...]}`` (``launches`` summed
over the serving paths, per path in ``launches_by_path``), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``. With ``--out DIR`` the details (``chip_smoke.json``) and the
compiler's register report (``ptxas.txt``) are written to DIR;
``--kernels-only`` stops after phase 2; ``--gguf-only`` runs phase 1 and
then phase 7 alone (both exit 4 by design: no result line).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import re
import resource
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from unittest import mock

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
SEED = 20261017
TENSOR_CORE_KERNELS = ("flash_prefill", "qmm4", "qmm", "decode_attention",
                       "paged_decode", "paged_decode_v2", "paged_decode_v4")
# libraries whose kernels must not spill registers (ptxas report)
NO_SPILL_KERNELS = ("qmm", "decode_attention", "paged_decode",
                    "paged_decode_v2", "paged_decode_v4")
# head dims of the served models (llama 128, phi3 96): the paged kernels
# must run each on their tensor-core path
SERVED_HEAD_DIMS = (128, 96)


def fail(msg: str) -> int:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    return 1


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def write_details(out_dir, details: dict):
    if out_dir:
        with open(os.path.join(out_dir, "chip_smoke.json"), "w") as f:
            json.dump(details, f, indent=1)


def bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


class Timer:
    """Mean device time of ``fn`` over ``iters`` launches, each after an
    L2 flush (a 256 MB write), so weights and pages come from HBM. A
    device-side spin (~0.5 ms) follows the flush, so the host's work to
    launch ``fn`` (its Python, a library's dispatch) is done before the
    start event runs and only device time lands between the events."""

    SPIN_CYCLES = 1_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.float32,
                                     device="cuda")

    def __call__(self, fn, iters: int = 10, warmup: int = 2) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        total = 0.0
        for _ in range(iters):
            self.flush_buf.zero_()
            torch.cuda._sleep(self.SPIN_CYCLES)
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters

    def host_us(self, fn, iters: int = 100) -> float:
        """Mean host time of one call of ``fn`` in µs: ``iters`` calls
        enqueued behind a device spin (~10 ms), so no call waits on the
        device and the host's own work (Python, allocations, launches) is
        what the clock reads."""
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        torch.cuda._sleep(20 * self.SPIN_CYCLES)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        took = time.perf_counter() - t0
        torch.cuda.synchronize()
        return took / iters * 1e6


def paged_inputs(torch, g, B, ps, NBLK, H, KvH, hd, bits, max_len, window,
                 serving=False, idle=0):
    """Random inputs of the paged-decode kernels on the card, from the
    generator ``g``: a two-layer pool (int8 or int4 codes with f32 scales,
    or bf16) holding each slot's live pages in a random order, tables [B,
    NBLK], lengths drawn over 1..max_len (``serving``: spread evenly over
    180..max_len, and the last ``idle`` slots at 0, as the engine hands
    its free slots), bf16 q. Returns the kernels' positional arguments
    (q, k_pool, v_pool, layer 1, tables, lengths, scale, softcap 0,
    window)."""
    dev, L = "cuda", 2
    if serving:
        lengths = torch.linspace(180, max_len, B - idle,
                                 device=dev).round().int()
        lengths = torch.cat([lengths, torch.zeros(idle, dtype=torch.int32,
                                                  device=dev)])
    else:
        lengths = torch.randint(1, max_len + 1, (B,), generator=g,
                                device=dev, dtype=torch.int32)
    live = (lengths.long() // ps + 1).clamp(max=NBLK)
    P = int(live.sum().item()) + 1
    perm = torch.randperm(P - 1, generator=g, device=dev).int() + 1
    tables = torch.zeros((B, NBLK), dtype=torch.int32, device=dev)
    off = 0
    for b in range(B):
        n = int(live[b])
        tables[b, :n] = perm[off:off + n]
        off += n

    def pool():
        scales = torch.rand((L, P, KvH, ps), generator=g, device=dev)
        if bits == 8:
            return {"q": torch.randint(-127, 128, (L, P, KvH, ps, hd),
                                       generator=g, device=dev,
                                       dtype=torch.int8),
                    "s": scales * 0.02 + 1e-3}
        if bits == 4:
            return {"q4": torch.randint(0, 256, (L, P, KvH, ps // 2, hd),
                                        generator=g, device=dev,
                                        dtype=torch.uint8),
                    "s": scales * 0.3 + 1e-2}
        return torch.randn((L, P, KvH, ps, hd), generator=g,
                           device=dev).to(torch.bfloat16)

    kp, vp = pool(), pool()
    qd = torch.randn((B, 1, H, hd), generator=g, device=dev).to(
        torch.bfloat16)
    return (qd, kp, vp, 1, tables, lengths, hd ** -0.5, 0.0, window)


def load_baseline_paged(root: str):
    """``ops/paged.py`` of the port in another checkout at ``root`` (its
    own package name, build directory and launch counters), so a call can
    time that commit's paged kernels beside this one's."""
    import importlib
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "ollama_operator_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "baseline_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_port"] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module("baseline_port.ops.paged")


def kernel_phases(torch, timer, report, baseline=None):
    import torch.nn.functional as F
    from ollama_operator_tpu_torch.ops import attention as A
    from ollama_operator_tpu_torch.ops import paged as PG
    from ollama_operator_tpu_torch.ops import quant as Q
    from ollama_operator_tpu_torch.ops.quant_cache import pool_bits
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev, bf = "cuda", torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def rowwise(out, ref, rows, label=lambda r: f"row {r}"):
        """Hold each of ``rows`` output rows (a query row, or a slot's
        [H, hd]) to 1% of its own largest |ref|: both sides round an f32
        result to bf16, and 1 bf16 ulp is at most 2^-7 (0.8%) of a value.
        A row over thousands of keys has outputs ~50x smaller than one
        over a few, so one tolerance for all would let the long rows off.
        Returns (worst row's error, its tolerance, largest error of any
        row, which row was worst, the share of bf16 outputs that are not
        bit-equal to the plain version's)."""
        d = (out.float() - ref.float()).reshape(rows, -1).abs().amax(1)
        tol = 1e-2 * ref.float().reshape(rows, -1).abs().amax(1)
        w = int((d / tol.clamp(min=1e-30)).argmax())
        return (d[w].item(), tol[w].item(), d.max().item(), label(w),
                (out != ref).float().mean().item())

    # -- flash prefill: B=1, T=512, KvH=8, hd=128; H=32 (llama3.1 chunk,
    # G = 4) and H=24 (llama3.2:3b, G = 3)
    for H in (32, 24):
        B, T, KvH, hd = 1, 512, 8, 128
        q, k, v = (randn(B, T, H, hd), randn(B, KvH, T, hd),
                   randn(B, KvH, T, hd))
        scale = hd ** -0.5
        out = A.flash_prefill(q, k, v, scale)
        ref = A.flash_prefill_plain(q, k, v, scale)
        check = rowwise(out, ref, B * T, lambda r: f"query {r}")
        qh = q.transpose(1, 2)
        kr = k.repeat_interleave(H // KvH, dim=1)
        vr = v.repeat_interleave(H // KvH, dim=1)
        nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
        flops = 4 * H * hd * T * (T + 1) / 2
        report("flash_prefill", "csrc/flash_prefill.cu",
               "ollama_operator_tpu/ops/pallas/flash.py:134", check,
               timer(lambda: A.flash_prefill(q, k, v, scale)),
               timer(lambda: A.flash_prefill_plain(q, k, v, scale)),
               timer(lambda: F.scaled_dot_product_attention(
                   qh, kr, vr, is_causal=True, scale=scale)),
               *bound(nbytes, flops), shape=f"B={B} T={T} H={H} KvH={KvH} "
                                             f"hd={hd}", main=(H == 32))

    # -- flash prefill at phi3's admission shape: MHA (G = 1), hd 96,
    # T = 4096, window 2047 (the window bites); the library call is SDPA
    # with the band as a boolean mask
    B, T, H, hd, window = 1, 4096, 32, 96, 2047
    q, k, v = randn(B, T, H, hd), randn(B, H, T, hd), randn(B, H, T, hd)
    scale = hd ** -0.5
    out = A.flash_prefill(q, k, v, scale, 0.0, window)
    ref = A.flash_prefill_plain(q, k, v, scale, 0.0, window)
    check = rowwise(out, ref, B * T, lambda r: f"query {r}")
    i = torch.arange(T, device=dev)
    band = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None] - window)
    qh = q.transpose(1, 2)
    n_pairs = window * (window + 1) // 2 + (T - window) * window
    report("flash_prefill", "csrc/flash_prefill.cu",
           "ollama_operator_tpu/ops/pallas/flash.py:134", check,
           timer(lambda: A.flash_prefill(q, k, v, scale, 0.0, window)),
           timer(lambda: A.flash_prefill_plain(q, k, v, scale, 0.0, window),
                 iters=3, warmup=1),
           timer(lambda: F.scaled_dot_product_attention(
               qh, k, v, attn_mask=band, scale=scale)),
           *bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                  4 * H * hd * n_pairs),
           shape=f"B={B} T={T} H={H} KvH={H} hd={hd} window={window} "
                 f"(phi3)", main=False)
    del q, k, v, out, ref, band, qh

    # -- flash prefill at ragged chunks (T no multiple of the 64-row and
    # 64-key tiles): llama3.2:3b's heads at a 300-token prompt, and hd 80
    # with GQA, a 64-key window and a softcap of 30 at 200 tokens
    for B, T, H, KvH, hd, window, softcap in ((1, 300, 24, 8, 128, 0, 0.0),
                                              (2, 200, 8, 2, 80, 64, 30.0)):
        q, k, v = (randn(B, T, H, hd), randn(B, KvH, T, hd),
                   randn(B, KvH, T, hd))
        scale = hd ** -0.5
        args = (q, k, v, scale, softcap, window)
        out, ref = A.flash_prefill(*args), A.flash_prefill_plain(*args)
        check = rowwise(out, ref, B * T, lambda r: f"query {r}")
        i = torch.arange(T, device=dev)
        band = i[None, :] <= i[:, None]
        if window:
            band &= i[None, :] > i[:, None] - window
        n_pairs = int(band.sum().item())
        qh = q.transpose(1, 2)
        kr = k.repeat_interleave(H // KvH, dim=1)
        vr = v.repeat_interleave(H // KvH, dim=1)
        report("flash_prefill", "csrc/flash_prefill.cu",
               "ollama_operator_tpu/ops/pallas/flash.py:134", check,
               timer(lambda: A.flash_prefill(*args)),
               timer(lambda: A.flash_prefill_plain(*args)),
               None if softcap else timer(
                   lambda: F.scaled_dot_product_attention(
                       qh, kr, vr, attn_mask=band, scale=scale)),
               *bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                      4 * B * H * hd * n_pairs),
               shape=f"B={B} T={T} H={H} KvH={KvH} hd={hd} window={window} "
                     f"softcap={softcap} (ragged)", main=False)
        del q, k, v, out, ref, band, qh, kr, vr

    # -- paged decode over one layer of a two-layer pool, through each of
    # the three routes' kernels: K6 (v3, the default), K4 (v2,
    # TPU_PAGED_V3=0) and K5 (v4, TPU_PAGED_V4=1), each against the plain
    # version of its own contract. B=64, ps=128, lengths over 1..2048: int8
    # pool at H=32 (llama3.1) and H=24 (llama3.2:3b), int4 pool at H=24,
    # bf16 pool at H=32; then phi3's paged path: B=32, ps=64, H=KvH=32
    # (G = 1), hd 96, lengths over 1..4095, window 2047; then the int8 H=32
    # shape with nblk cut to half the longest slot's live pages (v2 and v4
    # ignore the keys past nblk * ps, v3 walks them all)
    paged_kernels = (
        ("v3", "csrc/paged_decode.cu",
         "ollama_operator_tpu/ops/pallas/paged.py:609"),
        ("v2", "csrc/paged_decode_v2.cu",
         "ollama_operator_tpu/ops/pallas/paged.py:165"),
        ("v4", "csrc/paged_decode_v4.cu",
         "ollama_operator_tpu/ops/pallas/paged.py:414"))

    inputs = {}

    def paged_case(B, ps, NBLK, H, KvH, hd, bits, max_len, window,
                   main_routes, cut=False, routes=("v3", "v2", "v4"),
                   serving=False, chunk=None, idle=0, v4_ctas=None):
        """``main_routes``: the routes whose main-path shape this is.
        ``serving``: lengths spread evenly over 180..max_len (a decode
        step's slots at the serving paths' prompt lengths) instead of drawn
        over 1..max_len, the last ``idle`` slots at 0. ``chunk``: the v3
        and v2 chunk in positions (``PG.PAGED_CHUNK`` by default);
        ``v4_ctas``: the v4 kernel's CTAs a call (``PG.PAGED_V4_CTAS``).
        Every row checks two launches bit-equal and reads the wrapper's
        host time a call; where ``nblk`` covers every live page, v2 and
        v4 must give v3's bits (their partials are v3's live chunks',
        merged in the same order); with a baseline, times that commit's
        kernel of the route beside it, and fails unless its v3 kernel
        (K6) gives the same bits as this one."""
        # the rows of one shape (a chunk or CTA count beside the default)
        # share its inputs, drawn once in the order the shapes first come
        key = (B, ps, NBLK, H, KvH, hd, bits, max_len, window, serving,
               idle)
        if key not in inputs:
            inputs[key] = paged_inputs(torch, g, B, ps, NBLK, H, KvH, hd,
                                       bits, max_len, window, serving, idle)
        args = inputs[key]
        qd, kp, _, _, _, lengths = args[:6]
        nblk = int((lengths.long() // ps + 1).max().item())
        if cut:
            nblk //= 2
        code_bytes = hd * pool_bits(kp) // 8 + (4 if bits < 16 else 0)
        knobs = (("PAGED_CHUNK", chunk), ("PAGED_V4_CTAS", v4_ctas))
        saved = {k: getattr(PG, k) for k, _ in knobs}
        saved_base_chunk = baseline and baseline.PAGED_CHUNK
        for k, v in knobs:
            if v:
                setattr(PG, k, v)
        if baseline is not None and chunk:
            baseline.PAGED_CHUNK = chunk
        out_v3 = None
        for route, source, replaces in paged_kernels:
            if route not in routes:
                continue
            fn = getattr(PG, f"paged_decode_attention_{route}")
            out = fn(*args, nblk=nblk)
            if route == "v3":
                out_v3 = out
            elif out_v3 is not None and not cut and not torch.equal(
                    out, out_v3):
                raise RuntimeError(f"the {route} kernel's output differs "
                                   f"from the v3 kernel's on the same "
                                   f"live pages")
            ref = PG.paged_decode_attention_plain(*args, nblk=nblk,
                                                  route=route)
            check = rowwise(out, ref, B, lambda r: f"slot {r} (length "
                            f"{int(lengths[r])})")
            # each kernel merges its partials in a fixed order: a repeat
            # gives the same bits
            if not torch.equal(fn(*args, nblk=nblk), out):
                raise RuntimeError(f"two launches of the {route} kernel "
                                   f"differ")
            extra = {"host_us": timer.host_us(lambda: fn(*args, nblk=nblk))}
            if baseline is not None:
                old = getattr(baseline, f"paged_decode_attention_{route}")
                same = torch.equal(old(*args, nblk=nblk), out)
                extra["baseline"] = dict(
                    ms=timer(lambda: old(*args, nblk=nblk)),
                    host_us=timer.host_us(lambda: old(*args, nblk=nblk)),
                    bit_equal=same)
                if route == "v3" and not same:
                    raise RuntimeError("the v3 kernel's output differs from "
                                       "the baseline commit's")
            # the positions this route attends: keys 0..length (inside the
            # window), below nblk * ps for v2 and v4
            last = lengths.long() + 1
            if route != "v3":
                last = last.clamp(max=nblk * ps)
            lo = ((lengths.long() - window + 1).clamp(min=0) if window
                  else torch.zeros_like(last))
            n_pos = int((last - lo).clamp(min=0).sum().item())
            # every attended position's codes (hd bytes, hd / 2 for int4,
            # 2 hd for bf16) and f32 scale, for K and V, per kv head; q in,
            # out back, the tables
            nbytes = (2 * 2 * qd.numel() + 2 * KvH * n_pos * code_bytes
                      + 4 * B * NBLK + 4 * B)
            flops = 4 * H * hd * n_pos
            v4_chunks = PG.paged_v4_chunks(
                B, KvH, -(-nblk // PG.paged_chunk_pages(ps)))
            name = ("paged_decode" if route == "v3" else
                    f"paged_decode_{route}")
            if route == "v3" and bits == 4:
                name = "paged_decode_int4"
            report(name, source, replaces, check,
                   timer(lambda: fn(*args, nblk=nblk)),
                   timer(lambda: PG.paged_decode_attention_plain(
                       *args, nblk=nblk, route=route)),
                   None, *bound(nbytes, flops),
                   shape=f"B={B} H={H} KvH={KvH} hd={hd} ps={ps} "
                         f"{'bf16' if bits == 16 else f'int{bits}'}, "
                         f"lengths {180 if serving else 1}..{max_len}"
                         + (f" and {idle} idle slots at 0" if idle else "")
                         + (f" window {window}" if window else "")
                         + (f" nblk {nblk} < longest {nblk * 2}" if cut
                            else "")
                         + f" ({n_pos} attended positions)"
                         + f" chunk {PG.PAGED_CHUNK}"
                         + (f" CTAs {KvH * v4_chunks}" if route == "v4"
                            else ""),
                   main=route in main_routes and not (chunk or v4_ctas),
                   **extra)
            del ref
        del out, out_v3
        for k, v in saved.items():
            setattr(PG, k, v)
        if baseline is not None and chunk:
            baseline.PAGED_CHUNK = saved_base_chunk

    for H, bits, main_routes in ((32, 8, ("v3", "v2")), (24, 8, ()),
                                 (24, 4, ("v3",)), (32, 16, ())):
        paged_case(64, 128, 32, H, 8, 128, bits, 2048, 0, main_routes)
    paged_case(32, 64, 64, 32, 32, 96, 8, 4095, 2047, ("v4",))
    paged_case(32, 64, 64, 32, 32, 96, 16, 4095, 2047, ())
    paged_case(64, 128, 32, 32, 8, 128, 8, 2048, 0, (), cut=True)
    # a decode step of the serving paths: 8 slots at 180..300 positions
    # (int8 pool at llama3.1's heads through K6 and K4 (path 7), and at
    # llama3.2:3b's, int4 pool at llama3.2:3b's, phi3's G = 1 on its
    # 64-position pages through K6 and K5 (path 8)), and that step as the
    # engine calls it, with every slot of its table (64 for llama, 32 for
    # phi3; the idle ones at length 0); then the main shape, the serving
    # lengths and phi3's shape at the neighbouring chunks of 256 and 1024
    # positions (K6), K4 at one page a CTA (128 positions: the TPU's (slot,
    # block) grid) and K5 at half and twice its CTAs (at the main shape: at
    # the engine's step its count is capped by the units there can be)
    paged_case(8, 128, 32, 32, 8, 128, 8, 300, 0, (), routes=("v3", "v2"),
               serving=True)
    for H, bits in ((24, 8), (24, 4)):
        paged_case(8, 128, 32, H, 8, 128, bits, 300, 0, (), routes=("v3",),
                   serving=True)
    paged_case(8, 64, 64, 32, 32, 96, 8, 300, 2047, (), routes=("v3", "v4"),
               serving=True)
    paged_case(64, 128, 32, 32, 8, 128, 8, 300, 0, (), routes=("v3", "v2"),
               serving=True, idle=56)
    paged_case(32, 64, 64, 32, 32, 96, 8, 300, 2047, (),
               routes=("v3", "v4"), serving=True, idle=24)
    for chunk in (256, 1024):
        paged_case(64, 128, 32, 32, 8, 128, 8, 2048, 0, (), routes=("v3",),
                   chunk=chunk)
        paged_case(8, 128, 32, 32, 8, 128, 8, 300, 0, (), routes=("v3",),
                   serving=True, chunk=chunk)
        paged_case(32, 64, 64, 32, 32, 96, 8, 4095, 2047, (),
                   routes=("v3",), chunk=chunk)
    paged_case(64, 128, 32, 32, 8, 128, 8, 2048, 0, (), routes=("v2",),
               chunk=128)
    paged_case(64, 128, 32, 32, 8, 128, 8, 300, 0, (), routes=("v2",),
               serving=True, idle=56, chunk=128)
    for ctas in (2048, 8192):
        paged_case(32, 64, 64, 32, 32, 96, 8, 4095, 2047, (),
                   routes=("v4",), v4_ctas=ctas)
    inputs.clear()
    torch.cuda.empty_cache()

    # -- dense-cache decode, B=8 slots of S=4096 rows, lengths spread over
    # 1..4095: K2 (GQA) at llama3.2:3b's heads (H=24, KvH=8, hd=128) with
    # no window and with a window of 2047, and with every slot at the
    # serving lengths (1..300 live rows), K3 (MHA) at phi3's (H=KvH=32,
    # hd=96, window 2047); then K2 at the main shape and at the serving
    # lengths, and K3 at its shape, with other sequence chunks than the
    # wrappers' (the measurement the chunk size was picked by); then K2 at
    # hd 64 with G = 8 and a softcap, and at head dims 256 and 72 (its
    # scalar kernel). The library call is SDPA over the full S with each
    # slot's visible rows as a boolean mask, K/V pre-repeated for GQA (none
    # for soft-capped scores). Each row also reads the wrapper's host time
    # a call (its checks, the partials' allocation and both launches)
    B, S = 8, 4096
    spread = torch.linspace(1, S - 1, B, device=dev).round().int()
    short = torch.linspace(1, 300, B, device=dev).round().int()
    kinds = {"decode_attention": (
                 A.decode_attention, A.decode_attention_plain,
                 "ollama_operator_tpu/ops/pallas/flash.py:240"),
             "mha_decode": (
                 A.mha_decode_attention, A.mha_decode_attention_plain,
                 "ollama_operator_tpu/ops/pallas/flash.py:361")}
    # (kernel, H, KvH, hd, window, softcap, lengths, main, chunk knob)
    dense_cases = [
        ("decode_attention", 24, 8, 128, 0, 0.0, spread, True, None),
        ("decode_attention", 24, 8, 128, 2047, 0.0, spread, False, None),
        ("decode_attention", 24, 8, 128, 0, 0.0, short, False, None),
        ("mha_decode", 32, 32, 96, 2047, 0.0, spread, True, None)]
    for chunk in (128, 512):
        for lengths in (spread, short):
            dense_cases.append(("decode_attention", 24, 8, 128, 0, 0.0,
                                lengths, False, ("DECODE_CHUNK", chunk)))
        dense_cases.append(("mha_decode", 32, 32, 96, 2047, 0.0, spread,
                            False, ("DECODE_CHUNK", chunk)))
    # K2's tensor-core kernel at another head dim and a full group (hd 64,
    # G = 8) with soft-capped scores; then at head dims it does not take
    # (256, and 72: no multiple of 16), where the split scalar kernel serves
    dense_cases.append(("decode_attention", 32, 4, 64, 0, 30.0, spread,
                        False, None))
    for H, KvH, hd in ((4, 2, 256), (6, 2, 72)):
        dense_cases.append(("decode_attention", H, KvH, hd, 0, 0.0, spread,
                            False, None))
    for (name, H, KvH, hd, window, softcap, lengths, main,
         knob) in dense_cases:
        fn, plain, replaces = kinds[name]
        saved = (knob[0], getattr(A, knob[0])) if knob else None
        if knob:
            setattr(A, *knob)
        k, v, qd = randn(B, KvH, S, hd), randn(B, KvH, S, hd), randn(
            B, 1, H, hd)
        scale = hd ** -0.5
        args = (qd, k, v, lengths, scale, softcap, window)
        out, ref = fn(*args), plain(*args)
        check = rowwise(out, ref, B, lambda r: f"slot {r} (q_pos "
                        f"{int(lengths[r])})")
        kpos = torch.arange(S, device=dev)[None, :]
        visible = kpos <= lengths.long()[:, None]
        if window:
            visible &= kpos > lengths.long()[:, None] - window
        n_live = int(visible.sum().item())
        G = H // KvH
        kr, vr = (x.repeat_interleave(G, dim=1) for x in (k, v))
        qh = qd.transpose(1, 2)
        report(name, "csrc/decode_attention.cu", replaces, check,
               timer(lambda: fn(*args)), timer(lambda: plain(*args)),
               None if softcap else timer(
                   lambda: F.scaled_dot_product_attention(
                       qh, kr, vr, attn_mask=visible[:, None, None, :],
                       scale=scale)),
               # the live K/V rows once per kv head, q in, out back
               *bound(2 * 2 * KvH * n_live * hd + 2 * 2 * qd.numel()
                      + 4 * B, 4 * H * hd * n_live),
               shape=f"B={B} H={H} KvH={KvH} hd={hd} S={S} lengths "
                     f"1..{int(lengths.max())} window {window} softcap "
                     f"{softcap} ({n_live} live rows) chunk "
                     f"{A.DECODE_CHUNK}",
               main=main, host_us=timer.host_us(lambda: fn(*args)))
        if saved:
            setattr(A, *saved)
        del k, v, kr, vr, out, ref

    # -- the tied LM head's f32 product (llama3.2:3b: 8 rows, D 3072,
    # vocab 128256): one bf16 GEMM with an f32 output (aten::mm.dtype, a
    # library call the port makes, as the JAX package leaves this product
    # to XLA) against the f32 product of the same bf16 values
    from ollama_operator_tpu_torch.models.decoder import _mm_f32
    xh, emb = randn(8, 3072), randn(128256, 3072, scale=0.02)
    got = _mm_f32(xh, emb.t())
    want = xh.float() @ emb.float().t()
    err = (got - want).abs().max().item()
    htol = 1e-5 * want.abs().max().item()   # f32 sums in another order
    print(f"tied head (aten::mm.dtype) [N=8 K=3072 V=128256]: dtype "
          f"{got.dtype}; max|err| {err:.3g} against the f32 product (tol "
          f"{htol:.3g})", flush=True)
    if got.dtype != torch.float32 or not err <= htol:
        raise RuntimeError("the tied head's f32 product disagrees")
    del xh, emb, got, want

    # -- dequant matmuls on every projection shape: qmm4 (int4) at
    # llama3.1's, N in {1, 64, 512}; qmm (int8) at llama3.2:3b's, N in {1,
    # 8, 17, 64, 512} (8: the dense paths' decode, where qmm takes the
    # decode form; 17: the first N past it). Each kernel and its plain
    # version sum f32 products of the same values in another order: the
    # tensor cores (bf16 x bf16 products exact, accumulated in f32 over k16
    # steps and then across K groups, splits summed in a fixed order): a
    # few f32 ulps of sums of |y| ~ 1, far inside 1e-3
    for name, fn, plain, quant, replaces, shapes, main, rows in (
            ("qmm4", Q.qmm4, Q.qmm4_plain, Q.quantize_groupwise_int4,
             "ollama_operator_tpu/ops/pallas/quant.py:142",
             {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
              "w_gate/w_up": (4096, 14336), "w_down": (14336, 4096),
              "lm_head": (4096, 128256)}, "w_gate/w_up", (1, 64, 512)),
            ("qmm", Q.qmm, Q.qmm_plain, Q.quantize_groupwise,
             "ollama_operator_tpu/ops/pallas/quant.py:73",
             {"wq/wo": (3072, 3072), "wk/wv": (3072, 1024),
              "w_gate/w_up": (3072, 8192), "w_down": (8192, 3072)},
             "w_gate/w_up", (1, 8, 17, 64, 512))):
        for wname, (K, O) in shapes.items():
            qw = quant(torch.randn((K, O), generator=g, device=dev) * 0.02)
            codes = qw["q4"] if "q4" in qw else qw["q"]
            wbf = Q.dequantize_groupwise(qw).to(bf)
            for N in rows:
                x = randn(N, K)
                out = fn(x, codes, qw["s"])
                ref = plain(x, codes, qw["s"])
                err = (out - ref).abs().max().item()
                qtol = 1e-3   # f32 sums of the same products, other order
                nbytes = (2 * N * K + codes.numel() + 4 * (K // 32) * O
                          + 4 * N * O)
                report(name, f"csrc/{name}.cu", replaces, (err, qtol),
                       timer(lambda: fn(x, codes, qw["s"])),
                       timer(lambda: plain(x, codes, qw["s"])),
                       timer(lambda: torch.matmul(x, wbf)),
                       *bound(nbytes, 2.0 * N * K * O),
                       shape=f"{wname} N={N} K={K} O={O}",
                       main=(wname == main and N == 64))
            del qw, codes, wbf
    # -- qmm at ragged last column tiles: phi3's untied LM head (O = 32064
    # = 125 x 256 + 64) at N = 32 rows (the paged path's slots), and
    # w_gate widened by 64 columns at N = 64
    for wname, N, K, O in (("lm_head phi3", 32, 3072, 32064),
                           ("w_gate + 64 (ragged)", 64, 3072, 8192 + 64)):
        qw = Q.quantize_groupwise(torch.randn((K, O), generator=g,
                                              device=dev) * 0.02)
        wbf = Q.dequantize_groupwise(qw).to(bf)
        x = randn(N, K)
        out = Q.qmm(x, qw["q"], qw["s"])
        ref = Q.qmm_plain(x, qw["q"], qw["s"])
        report("qmm", "csrc/qmm.cu",
               "ollama_operator_tpu/ops/pallas/quant.py:73",
               ((out - ref).abs().max().item(), 1e-3),
               timer(lambda: Q.qmm(x, qw["q"], qw["s"])),
               timer(lambda: Q.qmm_plain(x, qw["q"], qw["s"])),
               timer(lambda: torch.matmul(x, wbf)),
               *bound(2 * N * K + K * O + 4 * (K // 32) * O + 4 * N * O,
                      2.0 * N * K * O),
               shape=f"{wname} N={N} K={K} O={O}", main=False)
        del qw, wbf
    torch.cuda.empty_cache()


def byte_tokenizer(vocab: int):
    """256 byte pieces (every text encodes, one token per byte) and plain
    filler pieces up to the model's vocabulary; no EOG id, so every
    request runs to num_predict."""
    from ollama_operator_tpu_torch.tokenizer import Tokenizer
    tokens = [f"<0x{i:02X}>" for i in range(256)]
    tokens += [f"t{i}" for i in range(256, vocab)]
    return Tokenizer(model="llama", tokens=tokens,
                     token_types=[6] * 256 + [1] * (vocab - 256),
                     add_bos=False)


def dense_params(torch, cfg):
    """Random dense bf16 weights on the card, from the seed."""
    from ollama_operator_tpu_torch.models import decoder
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = decoder.init_params(cfg, g, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    return params


def post(port: int, body: dict) -> dict:
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/api/generate",
        data=json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        frames = [json.loads(x) for x in r.read().decode().splitlines()
                  if x.strip()]
    if any("error" in f for f in frames):
        raise RuntimeError(f"server error: {frames[-1]}")
    return frames[-1]


# (model preset, KV cache dtype, paged pool or dense slot cache, environment
# of the path, the paged-decode route it must take (None: dense), the
# counters its path must raise above 0, the counters it must leave at 0)
PAGED_COUNTERS = ("paged_decode", "paged_decode_int4", "paged_decode_v2",
                  "paged_decode_v4")
DENSE_COUNTERS = ("decode_attention", "mha_decode")
SERVING = (
    ("llama3.1", "int8", True, {}, "v3",
     ("flash_prefill", "paged_decode", "qmm4"),
     ("paged_decode_v2", "paged_decode_v4") + DENSE_COUNTERS),
    ("llama3.2:3b", "int8", True, {}, "v3",
     ("flash_prefill", "paged_decode", "qmm"),
     ("paged_decode_v2", "paged_decode_v4") + DENSE_COUNTERS),
    ("llama3.2:3b", "int4", True, {}, "v3",
     ("flash_prefill", "paged_decode_int4", "qmm"),
     ("paged_decode_v2", "paged_decode_v4") + DENSE_COUNTERS),
    ("phi3", "int8", True, {}, "v3", ("flash_prefill", "paged_decode", "qmm"),
     ("paged_decode_v2", "paged_decode_v4") + DENSE_COUNTERS),
    ("llama3.2:3b", "bfloat16", False, {}, None,
     ("flash_prefill", "decode_attention", "qmm"),
     PAGED_COUNTERS + ("mha_decode",)),
    ("phi3", "bfloat16", False, {"TPU_MHA_KERNEL": "1"}, None,
     ("flash_prefill", "mha_decode", "qmm"),
     PAGED_COUNTERS + ("decode_attention",)),
    ("llama3.1", "int8", True, {"TPU_PAGED_V3": "0"}, "v2",
     ("flash_prefill", "paged_decode_v2", "qmm4"),
     ("paged_decode", "paged_decode_int4", "paged_decode_v4")
     + DENSE_COUNTERS),
    ("phi3", "int8", True, {"TPU_PAGED_V4": "1"}, "v4",
     ("flash_prefill", "paged_decode_v4", "qmm"),
     ("paged_decode", "paged_decode_int4", "paged_decode_v2")
     + DENSE_COUNTERS))


# the depth of each serving path (None: full depth). Path 1 stays at full
# depth (phase 5 runs on it); paths 2-8 are cut to 8 layers to keep the
# run inside its time limit now that path 9 serves llama3.2:3b, path 2's
# model and cache, at full depth from a GGUF
SERVING_LAYERS = (None, 8, 8, 8, 8, 8, 8, 8)


def serving_phase(torch, details, model: str, kv_dtype: str, paged: bool,
                  route, expect, absent, keep: bool = False, layers=None):
    """Serve ``model`` at full width behind the HTTP server: dense bf16
    weights from the seed go through ``ModelManager.preload``, which
    resolves the weight dtype itself (int4 at 4e9 parameters or more, int8
    below), on a ``kv_dtype`` page pool (``paged``) or dense slot cache at
    the serving defaults. With ``layers`` the model is cut to that depth
    and served in the weight dtype its full depth resolves to. Eight
    concurrent greedy requests, then two repeats of one. Returns the
    launch counts of the eight requests (and, with ``keep``, the path's
    record, model manager, server and model, still serving, for
    :func:`close_serving`)."""
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import cuda_build
    from ollama_operator_tpu_torch.ops.paged import paged_route
    from ollama_operator_tpu_torch.runtime.engine import resolve_engine_dtype
    from ollama_operator_tpu_torch.server.app import ModelManager, serve
    full = get_config(model)
    cfg = full if layers is None else dataclasses.replace(full,
                                                          n_layers=layers)
    if paged and paged_route() != route:
        raise RuntimeError(f"paged route {paged_route()}, expected {route}")
    t0 = time.perf_counter()
    params = dense_params(torch, cfg)
    mm = ModelManager()            # the card: no device argument
    lm = mm.preload(model, cfg, params, byte_tokenizer(cfg.vocab_size),
                    dtype=(None if layers is None
                           else resolve_engine_dtype(full, "cuda")),
                    template="{{ .Prompt }}", kv_dtype=kv_dtype, paged=paged)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_build = time.perf_counter() - t0
    if lm.serving_dtype != resolve_engine_dtype(full, "cuda"):
        raise RuntimeError(f"{model} serves {lm.serving_dtype}")
    e = lm.ecfg
    if lm.engine.paged != paged:
        raise RuntimeError(f"{model} resolved paged={lm.engine.paged}")
    tag = (f"{model} {lm.serving_dtype} weights, {kv_dtype} "
           f"{f'paged ({route}) ' if paged else 'dense '}KV, "
           f"{cfg.n_layers} layers")
    print(f"serving {tag}: slots={e.max_slots} page_size={e.page_size} "
          f"pages={e.n_pages} max_seq={e.max_seq_len} "
          f"chunk={e.decode_chunk} kv={e.cache_dtype} "
          f"kv_bytes={lm.engine.kv_bytes / 1e9:.2f}GB "
          f"mem_allocated={torch.cuda.memory_allocated() / 1e9:.2f}GB "
          f"build_s={t_build:.1f}", flush=True)
    httpd = serve(mm, "127.0.0.1", 0)
    port = httpd.server_address[1]
    out = None
    try:
        words = ("paged attention over quantized weights on one card "
                 "serves many slots at once").split()
        prompts = [" ".join(words[(i + j) % len(words)]
                            for j in range(12 + 4 * i))[:240]
                   for i in range(8)]
        opts = {"temperature": 0, "num_predict": 32}
        post(port, {"model": model, "prompt": "warm up",
                    "stream": False, "options": opts})
        for name in cuda_build.launches:
            cuda_build.launches[name] = 0
        results = [None] * len(prompts)
        errors = []

        def run(i):
            try:
                results[i] = post(port, {"model": model,
                                         "prompt": prompts[i],
                                         "options": opts})
            except Exception as ex:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {ex!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        launches = dict(cuda_build.launches)
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"requests failed: {errors}")
        for i, r in enumerate(results):
            if not r.get("done") or r.get("eval_count") != 32:
                raise RuntimeError(f"request {i} ended {r}")
        # a repeat extends the prefix the request left in the cache (the
        # radix tree, or its parked slot on the dense cache), so its bits
        # come from the extend path, not from the cold admission's
        # prefill: two repeats extend the same cached prefix and must give
        # the same tokens; the cold run's are compared and reported
        reps = [lm.generate(prompts[3], opts) for _ in range(2)]
        if min(r.reused_tokens for r in reps) <= 0:
            raise RuntimeError(f"a repeated prompt reused no cached prefix "
                               f"({[r.reused_tokens for r in reps]})")
        if reps[1].context != reps[0].context:
            raise RuntimeError("two repeats of a greedy prompt, each "
                               "extending the same cached prefix, gave "
                               "other tokens")
        cold_ctx = results[3]["context"]
        rep_equal_cold = sum(a == b for a, b in zip(reps[0].context,
                                                    cold_ctx))
        missing = [k for k in expect if launches[k] <= 0]
        if missing:
            raise RuntimeError(f"kernels not launched while serving {tag}: "
                               f"{missing} ({launches})")
        stray = [k for k in absent if launches[k] != 0]
        if stray:
            raise RuntimeError(f"kernels of another path launched while "
                               f"serving {tag}: {stray} ({launches})")
        n_tok = sum(r["eval_count"] for r in results)
        ttft = sorted(r["prompt_eval_duration"] / 1e6 for r in results)
        out = {"model": model, "layers": cfg.n_layers,
               "weights": lm.serving_dtype, "kv": kv_dtype,
               "paged": paged, "route": route, "requests": len(results),
               "wall_s": wall,
               "generated_tokens": n_tok, "aggregate_tok_s": n_tok / wall,
               "ttft_ms": ttft, "kv_bytes": lm.engine.kv_bytes,
               "prompt_tokens": [r["prompt_eval_count"] for r in results],
               "repeat_reused_tokens": reps[0].reused_tokens,
               "repeat_tokens_equal_to_cold": rep_equal_cold,
               "repeat_context_len": len(cold_ctx),
               "launches": launches}
        print(f"serving {tag}: {len(results)} requests x 32 tokens in "
              f"{wall:.3f} s: {n_tok / wall:.1f} tok/s aggregate; TTFT ms "
              f"min {ttft[0]:.1f} median {ttft[len(ttft) // 2]:.1f} max "
              f"{ttft[-1]:.1f}; launches {launches}; a repeat reused "
              f"{reps[0].reused_tokens} tokens and matched the cold run at "
              f"{rep_equal_cold}/{len(cold_ctx)} context positions",
              flush=True)
    except BaseException:
        close_serving(torch, details, out=None, mm=mm, httpd=httpd, lm=lm)
        raise
    if keep:
        return launches, (out, mm, httpd, lm)
    close_serving(torch, details, out, mm, httpd, lm)
    return launches


def close_serving(torch, details, out, mm, httpd, lm):
    """Stop a serving path's server and model manager; with ``out``, time
    a decode step on its engine and record the path."""
    import gc
    httpd.shutdown()
    httpd.server_close()
    mm.shutdown()
    if out is not None:
        # the scheduler has stopped: drive its engine directly
        out["step"] = step_breakdown(torch, lm.engine)
        details.setdefault("serving", []).append(out)
    del lm
    gc.collect()
    torch.cuda.empty_cache()


def step_breakdown(torch, engine, n_slots: int = 8, n: int = 16) -> dict:
    """One decode dispatch of ``n`` steps for ``n_slots`` greedy slots
    (200-token prompts), straight on the engine after its scheduler has
    stopped: the host clock for enqueueing it and for finishing it, and
    the device's busy time from ``torch.profiler`` (the kernels' own
    times; "not measured" when the profiler records none)."""
    from torch.profiler import ProfilerActivity, profile

    from ollama_operator_tpu_torch.runtime.engine import SlotOptions
    g = torch.Generator().manual_seed(SEED)
    greedy = SlotOptions(temperature=0)
    for slot in range(n_slots):
        engine.admit(slot, torch.randint(0, engine.cfg.vocab_size, (200,),
                                         generator=g).numpy(), greedy)
    engine.decode_n_launch(4).wait()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    handle = engine.decode_n_launch(n)
    t_enqueue = time.perf_counter() - t0
    handle.wait()
    t_wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.decode_n_launch(n).wait()
    cuda = getattr(torch.autograd.DeviceType, "CUDA", None)
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / n
    by_name = collections.Counter()
    for e in kernels:    # names cut to 100 characters, their times summed
        by_name[e.key[:100]] += dev_us(e) / 1e3 / n
    for slot in range(n_slots):
        engine.release(slot)
    out = {"slots": n_slots, "steps": n,
           "host_enqueue_ms_per_step": t_enqueue * 1e3 / n,
           "wall_ms_per_step": t_wall * 1e3 / n,
           "device_busy_ms_per_step": busy_ms if kernels else "not measured",
           "device_busy_share": (busy_ms / (t_wall * 1e3 / n)
                                 if kernels else "not measured"),
           "kernel_launches_per_step": (sum(e.count for e in kernels) / n
                                        if kernels else "not measured"),
           "top_kernels_ms_per_step": dict(by_name.most_common(8))}
    print(f"decode step ({n_slots} slots, {n} steps): host enqueue "
          f"{out['host_enqueue_ms_per_step']:.2f} ms/step, wall "
          f"{out['wall_ms_per_step']:.2f} ms/step, device busy "
          f"{out['device_busy_ms_per_step']} ms/step, launches/step "
          f"{out['kernel_launches_per_step']}", flush=True)
    return out


def cross_check(torch, details, model: str, bits: int, kv_dtype: str,
                paged: bool = True):
    """Two layers at full width: kernel path vs plain path on the card,
    ``bits``-bit weights on a ``kv_dtype`` page pool (``paged``) or dense
    slot cache."""
    from ollama_operator_tpu_torch.models import decoder
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import attention as A
    from ollama_operator_tpu_torch.ops import paged as PG
    from ollama_operator_tpu_torch.ops import quant as Q
    cfg = dataclasses.replace(get_config(model), n_layers=2)
    params = Q.quantize_params(dense_params(torch, cfg), bits=bits)
    dev = "cuda"
    mm_name = "qmm4" if bits == 4 else "qmm"

    def plain_matmul(x, w, out_dtype=None):
        if not Q.is_quantized(w):
            y = x @ w
            return y.to(out_dtype) if out_dtype is not None else y
        x2 = x.reshape(-1, x.shape[-1])
        y = (Q.qmm4_plain(x2, w["q4"], w["s"]) if Q.is_int4(w)
             else Q.qmm_plain(x2, w["q"], w["s"]))
        return y.reshape(*x.shape[:-1], -1).to(out_dtype or x.dtype)

    def plain_chunk(cfg, q, k, v, scale):
        return A.flash_prefill_plain(q, k, v, scale, cfg.attn_softcap,
                                     cfg.sliding_window)

    plain_fns = {mm_name: (Q, "matmul", plain_matmul),
                 "flash_prefill": (decoder, "chunk_attention", plain_chunk)}
    if paged:
        plain_fns["paged_decode"] = (decoder, "paged_decode_attention",
                                     PG.paged_decode_attention_plain)
    else:
        plain_fns["decode_attention"] = (A, "decode_attention",
                                         A.decode_attention_plain)
        plain_fns["mha_decode"] = (A, "mha_decode_attention",
                                   A.mha_decode_attention_plain)

    def run(plain=(), teacher=None):
        """Prefill 200 tokens, then 16 greedy decode steps; the names in
        ``plain`` run their plain versions. With ``teacher`` the steps
        are fed those tokens instead of their own argmax. Returns
        (logits [17, V] f32, argmax tokens)."""
        saved = {n: getattr(m, a) for n, (m, a, _) in plain_fns.items()}
        for n in plain:
            m, a, f = plain_fns[n]
            setattr(m, a, f)
        try:
            L, KvH, hd, ps, NBLK = 2, cfg.n_kv_heads, cfg.head_dim, 128, 32
            # paged: 8 pages of 128 rows; dense: one slot of 512 rows
            shp = (L, 8, KvH, ps, hd) if paged else (L, 1, KvH, 512, hd)

            def pool():
                if kv_dtype == "int4":
                    return {"q4": torch.zeros(shp[:3] + (ps // 2, hd),
                                              dtype=torch.uint8, device=dev),
                            "s": torch.zeros(shp[:-1], device=dev)}
                if kv_dtype == "int8":
                    return {"q": torch.zeros(shp, dtype=torch.int8,
                                             device=dev),
                            "s": torch.zeros(shp[:-1], device=dev)}
                return torch.zeros(shp, dtype=torch.bfloat16, device=dev)
            kp, vp = pool(), pool()
            n, bucket = 200, 256
            toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
            gen = torch.Generator(device="cpu").manual_seed(SEED)
            toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,),
                                        generator=gen).to(dev)
            table = torch.zeros((1, NBLK), dtype=torch.int32, device=dev)
            table[0, :3] = torch.tensor([4, 1, 6], dtype=torch.int32)
            logits, ks, vs = decoder.prefill_chunk(params, cfg, toks)
            if paged:
                decoder.paged_insert(cfg, kp, vp, ks, vs, table[0], n)
            else:
                decoder.dense_insert(kp, vp, ks, vs, 0)
            out = [logits[0, n - 1]]
            lengths = torch.tensor([n], dtype=torch.int32, device=dev)
            for step in range(16):
                tok = (out[-1].argmax() if teacher is None
                       else torch.tensor(teacher[step], device=dev))
                if paged:
                    lg, _, _ = decoder.forward_with_cache_paged(
                        params, cfg, tok.view(1, 1), kp, vp, table, lengths,
                        3)
                else:
                    lg, _, _ = decoder.forward_with_cache(
                        params, cfg, tok.view(1, 1), kp, vp, lengths,
                        attn_len=bucket)
                out.append(lg[0, 0])
                lengths += 1
            out = torch.stack(out)
            return out, [int(t) for t in out.argmax(-1)]
        finally:
            for n, (m, a, _) in plain_fns.items():
                setattr(m, a, saved[n])

    lk, sk = run()
    # the plain path is fed the kernel path's tokens, so both see the same
    # inputs at every step
    lp, sp = run(plain=tuple(plain_fns), teacher=sk)
    step_err = (lk - lp).abs().amax(dim=-1).tolist()
    err = max(step_err)
    scale = lp.abs().max().item()
    tol = 3e-2 * max(1.0, scale)   # bf16 activations rounded in 2 orders
    top2 = lp.topk(2, dim=-1).values
    gaps = (top2[:, 0] - top2[:, 1]).tolist()
    # Greedy is decidable at a step when the plain path's top-2 gap
    # exceeds twice that step's largest logit difference: no difference
    # that small can reorder the two. There the tokens must be identical;
    # a step below that margin is a near-tie of the random 128k-way
    # distribution that bf16 rounding may break either way, and is listed.
    ties = [i for i in range(len(sk)) if gaps[i] <= 2 * step_err[i]]
    bad = [i for i in range(len(sk)) if sk[i] != sp[i] and i not in ties]
    route = PG.paged_route() if paged else None
    tag = (f"{model} int{bits} weights, {kv_dtype} "
           f"{f'paged ({route})' if paged else 'dense'} KV")
    details.setdefault("cross_check", []).append({
        "model": model, "weights": f"int{bits}", "kv": kv_dtype,
        "paged": paged, "route": route, "kernels": sorted(plain_fns),
        "logit_max_abs_err": err, "logit_scale": scale, "tol": tol,
        "step_err": step_err, "plain_top2_gap": gaps,
        "near_tie_steps": ties, "kernel_tokens": sk, "plain_tokens": sp})
    print(f"cross-check {tag} (2 layers, full width, 17 steps): logits max "
          f"|err| {err:.4g} (tol {tol:.4g}, max |logit| {scale:.4g}); per "
          f"step {[round(e, 4) for e in step_err]}; tokens equal at "
          f"{sum(a == b for a, b in zip(sk, sp))}/{len(sk)} steps; "
          f"near-tie steps {ties} (gaps {[round(gaps[i], 4) for i in ties]})",
          flush=True)
    if bad or not err <= tol:
        # which kernel's plain version alone moves the kernel path?
        for name in plain_fns:
            lx, _ = run(plain=(name,), teacher=sk)
            e = (lk - lx).abs().amax(dim=-1).tolist()
            print(f"  with plain {name} only: per step "
                  f"{[round(x, 4) for x in e]}", flush=True)
        raise RuntimeError(f"kernel and plain paths disagree ({tag}): "
                           f"decidable tokens differ at steps {bad}, "
                           f"logits {err} vs tol {tol}")
    del params
    torch.cuda.empty_cache()


def prefix_phase(torch, details, lm) -> dict:
    """Prefix reuse and chunked prefill on path 1's model (llama3.1, int4
    weights, int8 pool, full width and depth), still serving, through
    ``LoadedModel.generate_stream`` with the prompt as token ids
    (``context``), at the serving defaults: the radix prefix cache on,
    ``TPU_MIN_PREFIX_REUSE`` 16, 256-token pieces.

    (a) A warm request (a 1000-token system prefix, 7 full pages of 128
    and a partial one, plus a 100-token tail) finishes, so its page 8 is
    donated full; then 8 concurrent requests with that prefix and distinct
    tails of 24 to 200 tokens must each reuse at least 1000 tokens and
    generate 32; two repeats of one must give the same tokens.
    (b) A 3000-token prompt arrives while 4 slots decode: it must be
    prefilled in 12 pieces with a decode dispatch between each two, and
    the flash-prefill, paged-decode and qmm4 kernels must launch during
    the phase. TTFT with and without a prefix hit, the reused tokens, the
    pieces and the largest gap between two decode dispatches (a decoding
    slot's tokens arrive once a dispatch) while the pieces ran are
    printed; none of them is a gate."""
    from ollama_operator_tpu_torch.ops import cuda_build
    eng, sched = lm.engine, lm.scheduler
    V = lm.cfg.vocab_size
    gen = torch.Generator().manual_seed(SEED + 13)

    def ids(n):
        # filler pieces only (ids >= 256): no byte sequence to hold back
        return torch.randint(256, V, (n,), generator=gen).tolist()

    def run(ctx, num_predict, times=None):
        res = None
        for _piece, r in lm.generate_stream(
                "", {"temperature": 0, "num_predict": num_predict},
                context=ctx):
            if times is not None:
                times.append(time.perf_counter())
            res = r if r is not None else res
        return res

    def concurrent(fns):
        outs, errors = [None] * len(fns), []

        def go(i):
            try:
                outs[i] = fns[i]()
            except Exception as ex:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {ex!r}")
        ts = [threading.Thread(target=go, args=(i,)) for i in range(len(fns))]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=900)
        if errors or any(t.is_alive() for t in ts):
            raise RuntimeError(f"requests failed: {errors}")
        return outs

    out = {}
    # (a) shared prefix
    prefix = ids(1000)
    warm = run(prefix + ids(100), 32)
    if warm.reused_tokens != 0 or warm.generated_tokens != 32:
        raise RuntimeError(f"warm request: reused {warm.reused_tokens}, "
                           f"generated {warm.generated_tokens}")
    tails = [24, 49, 74, 99, 124, 149, 174, 200]
    prompts = [prefix + ids(n) for n in tails]
    t0 = time.perf_counter()
    shared = concurrent([lambda p=p: run(p, 32) for p in prompts])
    wall = time.perf_counter() - t0
    bad = [(i, r.reused_tokens, r.generated_tokens)
           for i, r in enumerate(shared)
           if r.reused_tokens < 1000 or r.generated_tokens != 32]
    if bad:
        raise RuntimeError(f"shared-prefix requests (index, reused, "
                           f"generated): {bad}")
    reps = [run(prompts[0], 32) for _ in range(2)]
    if reps[1].context != reps[0].context:
        raise RuntimeError("two repeats of a stitched request gave other "
                           "tokens")
    rep_equal = sum(a == b for a, b in zip(reps[0].context,
                                           shared[0].context))
    ttft = sorted(r.ttft_s * 1e3 for r in shared)
    out["shared_prefix"] = {
        "prefix_tokens": len(prefix), "tails": tails,
        "warm_ttft_ms": warm.ttft_s * 1e3,
        "ttft_ms": ttft, "reused_tokens": [r.reused_tokens for r in shared],
        "wall_s": wall,
        "repeat_reused_tokens": [r.reused_tokens for r in reps],
        "repeat_ttft_ms": [r.ttft_s * 1e3 for r in reps],
        "repeat_equal_to_first_run": rep_equal,
        "context_len": len(shared[0].context),
        "radix_pages": eng.radix_pages}
    print(f"prefix phase (a): warm request (1100 prompt tokens, cold) TTFT "
          f"{warm.ttft_s * 1e3:.1f} ms; 8 concurrent requests on its "
          f"1000-token prefix reused {sorted(set(r.reused_tokens for r in shared))} "
          f"tokens, TTFT ms min {ttft[0]:.1f} median {ttft[4]:.1f} max "
          f"{ttft[-1]:.1f}, {wall:.3f} s for 8 x 32 tokens; repeats reused "
          f"{[r.reused_tokens for r in reps]} tokens, TTFT "
          f"{[round(r.ttft_s * 1e3, 1) for r in reps]} ms, equal to each "
          f"other, equal to the first run at {rep_equal}/"
          f"{len(shared[0].context)} context positions; radix pages "
          f"{eng.radix_pages}", flush=True)

    # (b) a 3000-token prompt in pieces while 4 slots decode
    calls = []
    for name in ("admit", "extend", "decode_n_launch"):
        def logged(*a, _fn=getattr(eng, name), _name=name, **kw):
            calls.append((_name, time.perf_counter()))
            return _fn(*a, **kw)
        setattr(eng, name, logged)
    for name in cuda_build.launches:
        cuda_build.launches[name] = 0
    pieces0 = sched.n_prefill_pieces
    try:
        n_dec = 16 * 32
        res = [None] * 5
        dec_prompts = [ids(100) for _ in range(4)]
        long_ids = ids(3000)
        window = {}

        def long_request():
            # once the four decoders are admitted and decoding
            t_end = time.perf_counter() + 600
            while int(eng.active.sum()) < 4:
                if time.perf_counter() > t_end:
                    raise RuntimeError("the decoding slots never started")
                time.sleep(0.001)
            window["t0"] = time.perf_counter()
            r = run(long_ids, 8)
            window["t1"] = window["t0"] + r.ttft_s
            res[4] = r

        def decoder(i):
            def go():
                res[i] = run(dec_prompts[i], n_dec)
            return go
        concurrent([decoder(i) for i in range(4)] + [long_request])
    finally:
        for name in ("admit", "extend", "decode_n_launch"):
            delattr(eng, name)
    launches = dict(cuda_build.launches)
    n_pieces = sched.n_prefill_pieces - pieces0
    t0, t1 = window["t0"], window["t1"]
    piece_t = [t for n, t in calls if n in ("admit", "extend")
               and t0 <= t <= t1]
    dec_t = [t for n, t in calls if n == "decode_n_launch"]
    between = [sum(a < t < b for t in dec_t)
               for a, b in zip(piece_t, piece_t[1:])]
    # a decoding slot gets its tokens once a dispatch: the largest gap
    # between two dispatches while the pieces ran, and the median one
    # outside that window (the decoders run on after the last piece)
    gaps = [b - a for a, b in zip(dec_t, dec_t[1:])]
    inside = [g for a, g in zip(dec_t, gaps) if a < t1 and a + g > t0]
    outside = sorted(g for a, g in zip(dec_t, gaps)
                     if a + g <= t0 or a >= t1)
    long_res = res[4]
    out["chunked"] = {
        "prompt_tokens": len(long_ids), "pieces": n_pieces,
        "piece_calls_in_window": len(piece_t),
        "decode_dispatches_between_pieces": between,
        "ttft_ms": long_res.ttft_s * 1e3,
        "max_decode_gap_ms": max(inside) * 1e3 if inside else None,
        "decode_gap_outside_ms_median": (
            outside[len(outside) // 2] * 1e3 if outside else None),
        "decoders_generated": [r.generated_tokens for r in res[:4]],
        "launches": launches}
    print(f"prefix phase (b): a 3000-token prompt in {n_pieces} pieces "
          f"(TTFT {long_res.ttft_s * 1e3:.1f} ms) while 4 slots decode; "
          f"decode dispatches between its pieces {between}; the largest gap "
          f"between two decode dispatches while the pieces ran "
          f"{out['chunked']['max_decode_gap_ms']} ms (median outside "
          f"them: {out['chunked']['decode_gap_outside_ms_median']} ms); "
          f"launches {launches}", flush=True)
    if n_pieces != 12 or len(piece_t) != 12:
        raise RuntimeError(f"the 3000-token prompt took {n_pieces} pieces "
                           f"({len(piece_t)} in its window), not 12")
    if not all(between):
        raise RuntimeError(f"no decode dispatch between some pieces: "
                           f"{between}")
    if long_res.generated_tokens != 8 or any(
            r.generated_tokens != n_dec for r in res[:4]):
        raise RuntimeError("a request of the chunked phase ended short")
    missing = [k for k in ("flash_prefill", "paged_decode", "qmm4")
               if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"kernels not launched in the chunked phase: "
                           f"{missing} ({launches})")
    details["prefix_phase"] = out
    return out


def prefix_cross_check(torch, details, model: str, bits: int,
                       kv_dtype: str, prefix_len: int, exact_gate: bool):
    """Two layers at full width on a ``kv_dtype`` page pool (page size
    128), through the engine's own calls, three slots decoding together:

    - a stitched extend (a donor request left 8 full pages in the radix
      tree whose first ``prefix_len`` tokens the prompt shares: 7 pages
      shared, the 8th copied; an odd ``prefix_len`` puts the tail's first
      int4 code in the prefix's last byte) against the same tail extended
      over a cold admission of the prefix (parked), and against a cold
      admission of the whole prompt;
    - a 3000-token prompt in 12 pieces of 256 against the same prompt in
      3 pieces (256, 1792, 952), and against its one-shot admission.

    Each pair's first-token logits and 8 greedy decode steps must agree
    within 3% of max |logit|, with the same tokens wherever greedy is
    decidable, and the stitched pages must be unchanged after the tail is
    written. The pairs against a cold or one-shot admission are gates
    only with ``exact_gate``: there the reference attends the prompt's
    exact K/V, while every extend attends the pool's rounded K/V (the
    prefix's and, written before attention, its own), so on a quantized
    pool they differ by the pool's rounding, in the JAX package's design
    as in the port; on the int4 pool they are reported."""
    from unittest import mock as _mock

    import numpy as np

    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import quant as Q
    from ollama_operator_tpu_torch.ops import sampling
    from ollama_operator_tpu_torch.runtime.engine import (
        Engine, EngineConfig, SlotOptions, resolve_cache_dtype)
    cfg = dataclasses.replace(get_config(model), n_layers=2)
    params = Q.quantize_params(dense_params(torch, cfg), bits=bits)
    eng = Engine(cfg, params, EngineConfig(
        max_slots=4, max_seq_len=4096, paged=True, page_size=128,
        n_pages=96, decode_chunk=1, cache_dtype=resolve_cache_dtype(
            kv_dtype, "cuda")), device="cuda")
    greedy = SlotOptions(temperature=0, repeat_penalty=1.0)
    gen = torch.Generator().manual_seed(SEED + 29)

    def ids(n):
        return torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()

    captured = []
    real_sample = sampling.sample

    def capture(logits, *a, **kw):
        captured.append(logits.float())
        return real_sample(logits, *a, **kw)

    def last_logits(fn, *a, **kw):
        captured.clear()
        fn(*a, **kw)
        return captured[-1][0]

    def steps(firsts, n=8):
        """The slots' first-token logits, then ``n`` joint greedy decode
        steps: slot → logits [n+1, V]."""
        rows = {s: [f] for s, f in firsts.items()}
        for _ in range(n):
            captured.clear()
            h = eng.decode_n_launch(1)
            h.wait()
            eng.retire(h.epoch)
            for s in rows:
                rows[s].append(captured[0][s])
        return {s: torch.stack(r) for s, r in rows.items()}

    def compare(name, ref, got, gate):
        ta, tb = ref.argmax(-1).tolist(), got.argmax(-1).tolist()
        err = (ref - got).abs().amax(-1).tolist()
        scale = ref.abs().max().item()
        tol = 3e-2 * max(1.0, scale)
        top2 = ref.topk(2, dim=-1).values
        gaps = (top2[:, 0] - top2[:, 1]).tolist()
        # each slot decodes its own tokens: steps after a divergence see
        # other inputs and are not compared
        upto = next((i + 1 for i in range(len(ta)) if ta[i] != tb[i]),
                    len(ta))
        ties = [i for i in range(upto) if gaps[i] <= 2 * err[i]]
        bad = [i for i in range(upto) if ta[i] != tb[i] and i not in ties]
        worst = max(err[:upto])
        ok = not bad and worst <= tol
        details.setdefault("prefix_cross_check", []).append({
            "check": name, "model": model, "weights": f"int{bits}",
            "kv": kv_dtype, "gate": gate, "ok": ok,
            "logit_max_abs_err": worst, "tol": tol, "logit_scale": scale,
            "step_err": err[:upto], "compared_steps": upto,
            "near_tie_steps": ties, "tokens_ref": ta, "tokens": tb})
        print(f"prefix cross-check {name}, {model} int{bits} weights, "
              f"{kv_dtype} pool (2 layers, full width): logits max |err| "
              f"{worst:.4g} (tol {tol:.4g}, max |logit| {scale:.4g}) over "
              f"{upto} steps; tokens equal at "
              f"{sum(a == b for a, b in zip(ta, tb))}/{len(ta)}; near-tie "
              f"steps {ties}; "
              f"{'gate' if gate else 'reported, not a gate'}: "
              f"{'ok' if ok else 'differs'}", flush=True)
        if gate and not ok:
            raise RuntimeError(f"{name} ({model}, {kv_dtype}): decidable "
                               f"tokens differ at {bad}, logits {worst} vs "
                               f"tol {tol}")

    with _mock.patch.object(sampling, "sample", capture):
        # a stitched extend against a parked one and a cold admission
        full = ids(prefix_len + 100)
        donor = np.concatenate([full[:prefix_len], ids(124)])
        first = eng.admit(3, donor, greedy)
        h = eng.decode_n_launch(1)
        h.wait()
        eng.retire(h.epoch)
        if eng.donate_prefix(3, list(donor) + [first]) != 1024:
            raise RuntimeError("the donor left no 8 full pages")
        cold = last_logits(eng.admit, 0, full, greedy)
        got = eng.stitch(1, full, eng.prefix_probe(full))
        if got != prefix_len:
            raise RuntimeError(f"stitched {got} tokens, expected "
                               f"{prefix_len}")
        shared = eng._pt.slot_pages(1)[:prefix_len // 128]
        pools = [t for c in (eng.k_cache, eng.v_cache)
                 for t in (c.values() if isinstance(c, dict) else (c,))]
        before = [t[:, shared].clone() for t in pools]
        stitched = last_logits(eng.extend, 1, full, got, greedy)
        eng.admit(2, full[:prefix_len])
        eng.release(2, park=True)
        parked = last_logits(eng.extend, 2, full, prefix_len, greedy)
        out = steps({0: cold, 1: stitched, 2: parked})
        if not all(torch.equal(t[:, shared], b)
                   for t, b in zip(pools, before)):
            raise RuntimeError("a stitched shared page changed")
        what = (f"stitched extend ({got} reused, boundary {got % 128} "
                f"into page {got // 128 + 1})")
        compare(f"{what} vs the tail over a parked cold prefix", out[2],
                out[1], True)
        compare(f"{what} vs a cold admission", out[0], out[1], exact_gate)
        for slot in range(3):
            eng.release(slot)
        # 12 pieces against 3 pieces and against one shot
        long_ids = ids(3000)

        def pieces(slot, cuts):
            eng.admit(slot, long_ids[:cuts[0]])
            for a, b in zip(cuts, cuts[1:]):
                eng.release(slot, park=True)
                if b < len(long_ids):
                    eng.extend(slot, long_ids[:b], a)
            return last_logits(eng.extend, slot, long_ids, cuts[-2], greedy)
        one = last_logits(eng.admit, 0, long_ids, greedy)
        twelve = pieces(1, list(range(256, 3000, 256)) + [3000])
        three = pieces(2, [256, 2048, 3000])
        out = steps({0: one, 1: twelve, 2: three})
        compare("12 pieces of 256 vs 3 pieces (256, 1792, 952), 3000 "
                "tokens", out[2], out[1], True)
        compare("12 pieces of 256 vs one-shot, 3000 tokens", out[0], out[1],
                exact_gate)
        for slot in range(3):
            eng.release(slot)
    eng._pt.check()
    del eng, params
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# 7. Path 9: a GGUF model pulled into the blob store and served by the
# port's own processes
# ---------------------------------------------------------------------------

GGUF_MODEL = "llama3.2:3b"
GGUF_PATH = "llama3.2:3b GGUF, pulled: int8 paged (v3) KV"
GGUF_REPO = ("library", "llama3.2", "3b")
GGUF_WORDS = ("paged attention over quantized weights on one card serves "
              "many slots at once").split()
GGUF_TOKEN_COUNTERS = ("flash_prefill", "paged_decode", "qmm")
GGUF_ABSENT = ("qmm4", "paged_decode_int4", "paged_decode_v2",
               "paged_decode_v4", "decode_attention", "mha_decode")


def gguf_vocab(n: int):
    """A ``llama`` (SentencePiece) vocabulary of ``n`` pieces: control
    pieces, the 256 byte-fallback pieces, "▁" and single characters, every
    prefix of each prompt word (so the merges reach whole words), then
    fillers. No end-of-generation id: every request runs to num_predict."""
    pieces = ["<unk>", "<s>", "</s>"] + [f"<0x{i:02X}>" for i in range(256)]
    types = [2, 3, 3] + [6] * 256
    normal = ["▁"] + [chr(c) for c in range(ord("a"), ord("z") + 1)]
    for w in sorted(set(GGUF_WORDS)):
        s = "▁" + w
        normal += [s[:k] for k in range(2, len(s) + 1)]
    normal = list(dict.fromkeys(normal))
    pieces += normal
    scores = [0.0] * len(types) + [float(len(p)) for p in normal]
    types += [1] * len(normal)
    fill = n - len(pieces)
    pieces += [f"▁f{i}" for i in range(fill)]
    scores += [0.0] * fill
    types += [1] * fill
    return pieces, scores, types


def write_gguf_model(path: str, cfg) -> dict:
    """Write ``cfg`` (llama3.2:3b, full width and depth) as a GGUF file
    from the seed, one tensor at a time: Q4_0 blocks for every 2-D layer
    weight, Q8_0 for ``token_embd`` (the tied head: no ``output.weight``),
    F32 norms, llama3 rope scaling as a ``rope_freqs`` tensor, and a
    128256-piece ``llama`` vocabulary with byte fallback. The blocks are
    drawn directly (random codes, f16 scales giving weights of std ~0.02),
    so no f32 weight tree is ever built."""
    import numpy as np

    from ollama_operator_tpu_torch.gguf import reader as R
    from ollama_operator_tpu_torch.gguf.writer import GGUFWriter
    from ollama_operator_tpu_torch.ops.rope import scaled_inv_freq
    rng = np.random.default_rng(SEED)
    w = GGUFWriter(path)
    for k, v in (("general.architecture", "llama"),
                 ("general.name", "llama3.2 3b (random weights)"),
                 ("general.file_type", 2),
                 ("general.parameter_count", int(cfg.n_params)),
                 ("llama.block_count", cfg.n_layers),
                 ("llama.context_length", cfg.max_seq_len),
                 ("llama.embedding_length", cfg.dim),
                 ("llama.feed_forward_length", cfg.ffn_dim),
                 ("llama.attention.head_count", cfg.n_heads),
                 ("llama.attention.head_count_kv", cfg.n_kv_heads),
                 ("llama.attention.key_length", cfg.head_dim),
                 ("llama.attention.value_length", cfg.head_dim),
                 ("llama.attention.layer_norm_rms_epsilon", cfg.norm_eps),
                 ("llama.rope.freq_base", cfg.rope_theta),
                 ("llama.rope.dimension_count", cfg.head_dim),
                 ("llama.vocab_size", cfg.vocab_size)):
        w.add_meta(k, v)
    tokens, scores, types = gguf_vocab(cfg.vocab_size)
    w.add_meta("tokenizer.ggml.model", "llama")
    w.add_meta("tokenizer.ggml.tokens", tokens)
    w.add_meta("tokenizer.ggml.scores", scores)
    w.add_meta("tokenizer.ggml.token_type", types)
    w.add_meta("tokenizer.ggml.bos_token_id", 1)
    w.add_meta("tokenizer.ggml.unknown_token_id", 0)

    def q4_0(name, shape):   # codes uniform 0..15: (q - 8) d, std ~4.6 d
        nb = shape[0] * shape[1] // 32
        blocks = np.frombuffer(rng.bytes(nb * 18), np.uint8).reshape(nb, 18)
        blocks = blocks.copy()
        d = (0.02 / 4.6 * (0.5 + rng.random(nb))).astype(np.float16)
        blocks[:, :2] = d.view(np.uint8).reshape(nb, 2)
        w.add_tensor_raw(name, shape, R.GGML_Q4_0, blocks.tobytes())

    def q8_0(name, shape):   # codes uniform -64..64: std ~37 d
        nb = shape[0] * shape[1] // 32
        q = rng.integers(-64, 65, (nb, 32), dtype=np.int8)
        d = (0.02 / 37 * (0.5 + rng.random(nb))).astype(np.float16)
        blocks = np.concatenate([d.view(np.uint8).reshape(nb, 2),
                                 q.view(np.uint8)], axis=1)
        w.add_tensor_raw(name, shape, R.GGML_Q8_0, blocks.tobytes())

    D, F, V = cfg.dim, cfg.ffn_dim, cfg.vocab_size
    QD, KVD = cfg.n_heads * cfg.head_dim, cfg.n_kv_heads * cfg.head_dim
    q8_0("token_embd.weight", (V, D))
    w.add_tensor_f32("output_norm.weight", np.ones(D, np.float32))
    base, _ = scaled_inv_freq(cfg.head_dim, cfg.rope_theta)
    l3, _ = scaled_inv_freq(
        cfg.head_dim, cfg.rope_theta, scaling_type=cfg.rope_scaling_type,
        factor=cfg.rope_scaling, orig_ctx=cfg.rope_orig_ctx,
        low_freq_factor=cfg.rope_low_freq_factor,
        high_freq_factor=cfg.rope_high_freq_factor)
    w.add_tensor_f32("rope_freqs.weight",
                     (np.asarray(base) / np.asarray(l3)).astype(np.float32))
    for i in range(cfg.n_layers):
        for leaf, shape in (("attn_q", (QD, D)), ("attn_k", (KVD, D)),
                            ("attn_v", (KVD, D)), ("attn_output", (D, QD)),
                            ("ffn_gate", (F, D)), ("ffn_up", (F, D)),
                            ("ffn_down", (D, F))):
            q4_0(f"blk.{i}.{leaf}.weight", shape)
        for leaf in ("attn_norm", "ffn_norm"):
            w.add_tensor_f32(f"blk.{i}.{leaf}.weight",
                             np.ones(D, np.float32))
    w.write()
    del w
    return {"path": path, "bytes": os.path.getsize(path)}


def sha256_file(path: str) -> str:
    import hashlib
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(8 << 20):
            h.update(chunk)
    return "sha256:" + h.hexdigest()


def start_registry(repo, layers):
    """A loopback registry serving one model: its manifest, and its blobs
    streamed from disk (``layers``: (media type, path) pairs)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    blobs, entries = {}, []
    for mt, path in layers:
        digest = sha256_file(path)
        blobs[digest] = path
        entries.append({"mediaType": mt, "digest": digest,
                        "size": os.path.getsize(path)})
    manifest = json.dumps({
        "schemaVersion": 2,
        "mediaType": "application/vnd.docker.distribution.manifest.v2+json",
        "config": entries[-1] | {
            "mediaType": "application/vnd.docker.container.image.v1+json"},
        "layers": entries[:-1]}).encode()
    ns, name, tag = repo

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            parts = self.path.split("?")[0].strip("/").split("/")
            if parts == ["v2", ns, name, "manifests", tag]:
                self.send_response(200)
                self.send_header("Content-Length", str(len(manifest)))
                self.end_headers()
                self.wfile.write(manifest)
                return
            path = (blobs.get(parts[-1]) if parts[:4] == ["v2", ns, name,
                                                          "blobs"] else None)
            if path is None:
                self.send_response(404)
                self.send_header("Content-Length", "0")
                self.end_headers()
                return
            self.send_response(200)
            self.send_header("Content-Length", str(os.path.getsize(path)))
            self.end_headers()
            with open(path, "rb") as f:
                while chunk := f.read(8 << 20):
                    self.wfile.write(chunk)

    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="registry").start()
    return httpd, {e["mediaType"]: e["digest"] for e in entries}


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def child_env() -> dict:
    """The environment of the port's processes: this one's, without proxy
    settings (every address is the loopback)."""
    env = {k: v for k, v in os.environ.items()
           if not k.lower().endswith("_proxy")}
    env["PYTHONUNBUFFERED"] = "1"
    return env


class PortServer:
    """``python -m ollama_operator_tpu_torch.server`` in a subprocess, its
    output in a log file; ``start`` returns once it answers ``GET /``."""

    def __init__(self, args, log_path: str):
        self.port = free_port()
        self.log = open(log_path, "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ollama_operator_tpu_torch.server",
             "--host", "127.0.0.1", "--port", str(self.port)] + args,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=child_env(), stdout=self.log, stderr=subprocess.STDOUT)

    def wait_ready(self, timeout: float = 600) -> float:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < timeout:
            if self.proc.poll() is not None:
                raise RuntimeError(f"server exited {self.proc.returncode}: "
                                   f"{self.tail()}")
            try:
                with urllib.request.urlopen(
                        f"http://127.0.0.1:{self.port}/", timeout=5) as r:
                    if r.status == 200:
                        return time.perf_counter() - t0
            except OSError:
                time.sleep(0.25)
        raise RuntimeError(f"server not up in {timeout} s: {self.tail()}")

    def tail(self, n: int = 3000) -> str:
        self.log.flush()
        self.log.seek(0)
        return self.log.read()[-n:]

    def get(self, path: str) -> dict:
        with urllib.request.urlopen(f"http://127.0.0.1:{self.port}{path}",
                                    timeout=60) as r:
            return json.loads(r.read())

    def memory(self) -> dict:
        """Host memory the server process holds now (``VmRSS`` of /proc,
        None where the kernel gives none) and the bytes its torch
        allocator holds on the card (``size_vram`` of /api/ps)."""
        out = {"rss": None}
        with open(f"/proc/{self.proc.pid}/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    out["rss"] = int(line.split()[1]) * 1024
        ps = self.get("/api/ps")["models"]
        out["size_vram"] = ps[0]["size_vram"] if ps else 0
        return out

    def launches(self) -> dict:
        return self.get("/api/ps")["models"][0]["kernel_launches"]

    def stop(self) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(2)     # SIGINT: the server's clean stop
            try:
                self.proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        return self.proc.returncode


def gguf_phase(torch, details, card: str, workdir: str) -> dict:
    """Path 9: write llama3.2:3b (full width and depth) as a GGUF from the
    seed, serve it from a loopback registry, pull it with the port's
    store server (``--store-only``) and pull CLI, load it with the port's
    model server (``--preload``: read, dequantized, transcoded and cached,
    then int8 weights, an int8 paged pool), serve 8 concurrent greedy
    requests, restart the server to load from the transcode cache, and
    hold its greedy streams against ``ModelManager.preload`` of the same
    ``load_model`` tree in this process. Returns the launch counts of the
    8 requests, read from the server's /api/ps just before and just after
    them."""
    from ollama_operator_tpu_torch.convert import params_from_numpy
    from ollama_operator_tpu_torch.gguf.transcode import load_model
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import cuda_build
    from ollama_operator_tpu_torch.runtime.engine import (
        EngineConfig, resolve_kv_dtype_default, resolve_serving_defaults)
    from ollama_operator_tpu_torch.server.app import (ModelManager,
                                                      transcode_dtype)
    from ollama_operator_tpu_torch.server.registry import (MT_MODEL,
                                                           MT_PARAMS,
                                                           MT_TEMPLATE)
    from ollama_operator_tpu_torch.tokenizer import Tokenizer
    cfg = get_config(GGUF_MODEL)
    out = {"model": GGUF_MODEL, "card": card}
    os.makedirs(workdir, exist_ok=True)
    t0 = time.perf_counter()
    g = write_gguf_model(os.path.join(workdir, "model.gguf"), cfg)
    out["gguf_bytes"] = g["bytes"]
    out["write_gguf_s"] = time.perf_counter() - t0
    for name, text in (("template", "{{ .Prompt }}"),
                       ("params", json.dumps({"temperature": 0})),
                       ("config", json.dumps({"model_format": "gguf"}))):
        with open(os.path.join(workdir, name), "w") as f:
            f.write(text)
    t0 = time.perf_counter()
    registry, digests = start_registry(GGUF_REPO, [
        (MT_MODEL, g["path"]),
        (MT_TEMPLATE, os.path.join(workdir, "template")),
        (MT_PARAMS, os.path.join(workdir, "params")),
        ("config", os.path.join(workdir, "config"))])
    out["registry_digest_s"] = time.perf_counter() - t0
    ref = (f"http://127.0.0.1:{registry.server_address[1]}/"
           f"{GGUF_REPO[0]}/{GGUF_REPO[1]}:{GGUF_REPO[2]}")
    store, cache = os.path.join(workdir, "store"), os.path.join(workdir,
                                                                "cache")
    print(f"path 9: wrote {g['bytes'] / 1e9:.3f} GB GGUF in "
          f"{out['write_gguf_s']:.1f} s; registry at {ref}", flush=True)
    servers = []
    try:
        # the store pod: --store-only, then the puller's CLI against it
        st = PortServer(["--store-only", "--store", store],
                        os.path.join(workdir, "store.log"))
        servers.append(st)
        st.wait_ready()
        env = child_env()
        env["OLLAMA_HOST"] = f"127.0.0.1:{st.port}"
        t0 = time.perf_counter()
        pull = subprocess.run(
            [sys.executable, "-m", "ollama_operator_tpu_torch.server.pull",
             ref], cwd=os.path.dirname(os.path.abspath(__file__)), env=env,
            capture_output=True, text=True, timeout=900)
        out["pull_s"] = time.perf_counter() - t0
        if pull.returncode != 0 or '"success"' not in pull.stdout:
            raise RuntimeError(f"pull failed ({pull.returncode}): "
                               f"{pull.stderr[-2000:]}")
        if st.stop() != 0:
            raise RuntimeError(f"store server stopped badly: {st.tail()}")
        blob = os.path.join(store, "blobs",
                            digests[MT_MODEL].replace(":", "-"))
        if os.path.getsize(blob) != g["bytes"]:
            raise RuntimeError("the pulled blob is not the GGUF")
        print(f"path 9: pulled through the store server in "
              f"{out['pull_s']:.1f} s", flush=True)

        # the model pod: --preload reads, dequantizes and transcodes
        args = ["--store", store, "--cache", cache, "--preload", ref]
        ms = PortServer(args, os.path.join(workdir, "model1.log"))
        servers.append(ms)
        out["load_transcode_s"] = ms.wait_ready()
        out["memory_after_transcode_load"] = ms.memory()
        log = ms.tail(20000)
        if "serving dtype for" not in log or "int8" not in log:
            raise RuntimeError(f"the server did not resolve int8: {log}")
        ps = ms.get("/api/ps")["models"][0]
        if (ps["details"]["serving_dtype"], ps["details"]["paged"]) != (
                "int8", True):
            raise RuntimeError(f"path 9 serves {ps['details']}")
        prompts = [" ".join(GGUF_WORDS[(i + j) % len(GGUF_WORDS)]
                            for j in range(12 + 4 * i))[:240]
                   for i in range(8)]
        opts = {"temperature": 0, "num_predict": 32}
        post(ms.port, {"model": ref, "prompt": "warm up",
                           "stream": False, "options": opts})
        before = ms.launches()
        results, errors = [None] * len(prompts), []

        def run(i):
            try:
                results[i] = post(ms.port, {"model": ref,
                                                "prompt": prompts[i],
                                                "options": opts})
            except Exception as ex:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {ex!r}")

        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        wall = time.perf_counter() - t0
        after = ms.launches()
        launches = {k: after[k] - before[k] for k in after}
        if errors or any(t.is_alive() for t in threads):
            raise RuntimeError(f"path 9 requests failed: {errors}")
        for i, r in enumerate(results):
            if not r.get("done") or r.get("eval_count") != 32:
                raise RuntimeError(f"path 9 request {i} ended {r}")
        missing = [k for k in GGUF_TOKEN_COUNTERS if launches[k] <= 0]
        stray = [k for k in GGUF_ABSENT if launches[k] != 0]
        if missing or stray:
            raise RuntimeError(f"path 9 launches {launches}: not launched "
                               f"{missing}, of another path {stray}")
        n_tok = sum(r["eval_count"] for r in results)
        ttft = sorted(r["prompt_eval_duration"] / 1e6 for r in results)
        out.update(requests=len(results), wall_s=wall,
                   generated_tokens=n_tok, aggregate_tok_s=n_tok / wall,
                   ttft_ms=ttft, launches=launches,
                   prompt_tokens=[r["prompt_eval_count"] for r in results],
                   serving=ps["details"])
        if ms.stop() != 0:
            raise RuntimeError(f"model server stopped badly: {ms.tail()}")
        # the peak resident memory of the processes reaped so far: the
        # store server, the pull and this model server, whose transcode
        # is the largest (Linux reports ru_maxrss in KiB)
        out["peak_rss_through_transcode"] = resource.getrusage(
            resource.RUSAGE_CHILDREN).ru_maxrss * 1024

        # the restart: a second load comes from the transcode cache
        entries = os.listdir(cache)
        stamp = {e: os.path.getmtime(os.path.join(cache, e, "weights.bin"))
                 for e in entries}
        ms2 = PortServer(args, os.path.join(workdir, "model2.log"))
        servers.append(ms2)
        out["load_from_cache_s"] = ms2.wait_ready()
        out["memory_after_cache_load"] = ms2.memory()
        if {e: os.path.getmtime(os.path.join(cache, e, "weights.bin"))
                for e in os.listdir(cache)} != stamp:
            raise RuntimeError("the restart transcoded again")
        out["cache_entries"] = entries
        served = [post(ms2.port, {"model": ref, "prompt": p,
                                      "stream": False, "options": opts})
                  for p in prompts]
        if ms2.stop() != 0:
            raise RuntimeError(f"model server stopped badly: {ms2.tail()}")
    finally:
        for s in servers:
            s.stop()
            s.log.close()
        registry.shutdown()
        registry.server_close()

    # the gate: the port's own load_model tree through preload, at int8
    # with the server's engine settings, gives the server's greedy streams
    t0 = time.perf_counter()
    gcfg, params, tok_md = load_model(
        blob, cache_dir=cache, dtype=transcode_dtype("int8", "cuda"),
        digest=digests[MT_MODEL].replace("sha256:", "")[:24])
    ecfg = resolve_serving_defaults(EngineConfig(
        max_slots=0, max_seq_len=4096, decode_chunk=0, page_size=0,
        paged=None, n_pages=None,
        cache_dtype=resolve_kv_dtype_default("cuda")), gcfg, "cuda")
    mm = ModelManager()
    lm = mm.preload(GGUF_MODEL, gcfg, params_from_numpy(params, "cuda"),
                    Tokenizer.from_gguf_metadata(tok_md), dtype="int8",
                    template="{{ .Prompt }}", ecfg=ecfg)
    del params
    out["preload_s"] = time.perf_counter() - t0
    try:
        if (lm.ecfg != ecfg or gcfg.n_params != cfg.n_params
                or lm.serving_dtype != "int8"):
            raise RuntimeError("the in-process model is not the server's")
        for name in cuda_build.launches:
            cuda_build.launches[name] = 0
        mine = [lm.generate(lm.render_prompt(p), opts) for p in prompts]
        equal = [a.context == b["context"] for a, b in zip(mine, served)]
        out["gate_streams_equal"] = f"{sum(equal)}/{len(equal)}"
        out["gate_launches_in_process"] = dict(cuda_build.launches)
    finally:
        mm.shutdown()
        del lm
        import gc
        gc.collect()
        torch.cuda.empty_cache()
    if not all(equal):
        raise RuntimeError(f"path 9: the HTTP server's greedy streams differ "
                           f"from preload of the same tree: {equal}")
    m1, m2 = out["memory_after_transcode_load"], out["memory_after_cache_load"]

    def gb(n):
        return "not measured" if not n else f"{n / 1e9:.2f} GB"
    print(f"path 9 [{card}]: {GGUF_MODEL} GGUF {out['gguf_bytes'] / 1e9:.3f}"
          f" GB written in {out['write_gguf_s']:.1f} s; pull "
          f"{out['pull_s']:.1f} s; server start + load with the transcode "
          f"{out['load_transcode_s']:.1f} s; start + load from the cache "
          f"{out['load_from_cache_s']:.1f} s; host RSS after load "
          f"{gb(m1['rss'])} / from the cache {gb(m2['rss'])}, peak through "
          f"the transcode {gb(out['peak_rss_through_transcode'])}; on the "
          f"card after load {gb(m1['size_vram'])} / {gb(m2['size_vram'])}",
          flush=True)
    print(f"path 9 [{card}]: {len(prompts)} requests x 32 tokens in "
          f"{out['wall_s']:.3f} s: {out['aggregate_tok_s']:.1f} tok/s "
          f"aggregate; TTFT ms min {ttft[0]:.1f} median "
          f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; launches "
          f"{launches}; HTTP streams equal to preload of the same tree: "
          f"{out['gate_streams_equal']}", flush=True)
    details["gguf_path"] = out
    return launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json and ptxas.txt")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="a checkout of another commit: also time its "
                         "paged-decode wrappers (K6, K4, K5) at each paged "
                         "row, and fail unless its K6 gives the same bits")
    ap.add_argument("--gguf-only", action="store_true",
                    help="build the kernels, then run path 9 (the pulled "
                         "GGUF model) alone; no result line")
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        return fail("torch is not installed")
    if not torch.cuda.is_available():
        return fail("CUDA is not available")
    try:
        from ollama_operator_tpu_torch.ops import cuda_build
    except ImportError as e:
        return fail(f"the port package is missing: {e}")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    out_dir = args.out
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    details = {}
    card = smi_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    took = cuda_build.build()
    t_build = time.perf_counter() - t0
    print(f"kernel build: {t_build:.1f} s ({took})", flush=True)
    if out_dir:
        with open(os.path.join(out_dir, "ptxas.txt"), "w") as f:
            for name in cuda_build.KERNELS:
                f.write(f"== {name}\n{cuda_build.ptxas_report(name)}\n")
    for name in cuda_build.KERNELS:
        for line in cuda_build.ptxas_report(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")
    details["card"] = card
    details["build_s"] = t_build
    # tensor-core instructions in each library's SASS: K1, K8, K7 and K2
    # run their products on the tensor cores
    sass = {name: cuda_build.tensor_core_instructions(name)
            for name in cuda_build.KERNELS}
    details["tensor_core_sass_lines"] = sass
    print(f"tensor-core SASS lines (HMMA/HGMMA) by library: {sass}",
          flush=True)
    missing = [n for n in TENSOR_CORE_KERNELS if sass[n] <= 0]
    if missing:
        return fail(f"no tensor-core instructions in {missing}")
    spills = [f"{n}: {line.strip()}" for n in NO_SPILL_KERNELS
              for line in cuda_build.ptxas_report(n).splitlines()
              if any(int(x) for x in re.findall(
                  r"(\d+) bytes spill (?:stores|loads)", line))]
    if spills:
        return fail(f"register spills: {spills}")
    import ctypes
    for lib in ("paged_decode", "paged_decode_v2", "paged_decode_v4"):
        on_tc = cuda_build.function(lib, f"{lib}_tensor_cores",
                                    [ctypes.c_int])
        scalar = [hd for hd in SERVED_HEAD_DIMS if on_tc(hd) != 1]
        print(f"{lib} on tensor cores at head dims {SERVED_HEAD_DIMS}: "
              f"{'no: ' + str(scalar) if scalar else 'yes'}", flush=True)
        if scalar:
            return fail(f"{lib} takes its scalar loop at the served head "
                        f"dims {scalar}")

    rows, entries = [], {}

    def report(name, source, replaces, check, ms, plain_ms, library_ms,
               bound_ms, bound_by, shape="", main=True, host_us=None,
               baseline=None):
        """``check``: (error, tolerance) over the whole output, or
        (worst row's error, its tolerance, largest error, worst row, share
        of outputs not bit-equal) from a row-wise check."""
        err, tol = check[:2]
        max_err, worst, differ = (check[2:] if len(check) > 2
                                  else (err, None, None))
        ok = err <= tol
        row = dict(name=name, shape=shape, max_abs_err=max_err, err=err,
                   tol=tol, worst=worst, bf16_not_bit_equal=differ, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, ok=ok,
                   host_us=host_us, baseline=baseline)
        rows.append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        held = (f"max|err| {err:.3g} (tol {tol:g})" if worst is None else
                f"worst {worst}: max|err| {err:.3g} (tol {tol:.3g}); "
                f"max|err| of all rows {max_err:.3g}; bf16 outputs not "
                f"bit-equal to the plain version: {differ:.4%}")
        host = "" if host_us is None else f"; host {host_us:.1f} us/call"
        if baseline:
            host += (f"; baseline commit: ms {baseline['ms']:.4f} host "
                     f"{baseline['host_us']:.1f} us/call, outputs "
                     f"{'bit-equal' if baseline['bit_equal'] else 'differ'}")
        print(f"kernel {name} [{shape}]: {held} "
              f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain {plain_ms:.4f} "
              f"library {lib} bound {bound_ms:.4f} ({bound_by}){host}",
              flush=True)
        e = entries.setdefault(name, dict(
            name=name, route="cuda", source="ollama_operator_tpu_torch/"
            + source, replaces=replaces, max_abs_err=0.0))
        e["max_abs_err"] = max(e["max_abs_err"], max_err)
        e["ok"] = e.get("ok", True) and ok
        if main:
            e.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms, shape=shape)

    if args.gguf_only:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_gguf_")
        try:
            gguf_phase(torch, details, card, workdir)
        except Exception as e:  # noqa: BLE001 — the phase's failure
            import traceback
            traceback.print_exc()
            return fail(f"path 9: {e!r}")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        write_details(out_dir, details)
        print("gguf-only run: no kernel rows; no result", flush=True)
        return 4
    try:
        timer = Timer(torch)
        baseline = (load_baseline_paged(args.baseline) if args.baseline
                    else None)
        kernel_phases(torch, timer, report, baseline)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — every phase failure is fatal
        import traceback
        traceback.print_exc()
        return fail(f"kernel phase: {e!r}")
    details["kernel_rows"] = rows
    print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
    bad = [r for r in rows if not r["ok"]]
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")
    if args.kernels_only:
        write_details(out_dir, details)
        print("kernels-only run: no serving phase; no result", flush=True)
        return 4

    launches_by_path = {}
    kept = None
    try:
        for i, (model, kv, paged, env, route, expect,
                absent) in enumerate(SERVING):
            layers = SERVING_LAYERS[i]
            path = (f"{model} {kv} "
                    f"{f'paged ({route})' if paged else 'dense'} KV"
                    + (f", {layers} layers" if layers else ""))
            with mock.patch.dict(os.environ, env):
                got = serving_phase(torch, details, model, kv, paged, route,
                                    expect, absent, keep=i == 0,
                                    layers=layers)
            if i == 0:
                # path 1 stays loaded for the prefix-and-chunk phase
                got, kept = got
            launches_by_path[path] = got
            print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        # 5. prefix reuse and chunked prefill on path 1, then its decode
        # step and its teardown
        try:
            prefix_phase(torch, details, kept[3])
        finally:
            close_serving(torch, details, *kept)
            kept = None
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        prefix_cross_check(torch, details, "llama3.1", 4, "int8", 1000,
                           exact_gate=True)
        prefix_cross_check(torch, details, "llama3.2:3b", 8, "int4", 1001,
                           exact_gate=False)
        prefix_cross_check(torch, details, "llama3.1", 4, "bfloat16", 1000,
                           exact_gate=True)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        cross_check(torch, details, "llama3.1", 4, "int8")
        cross_check(torch, details, "llama3.2:3b", 8, "int4")
        cross_check(torch, details, "llama3.2:3b", 8, "bfloat16",
                    paged=False)
        with mock.patch.dict(os.environ, {"TPU_MHA_KERNEL": "1"}):
            cross_check(torch, details, "phi3", 8, "bfloat16", paged=False)
        with mock.patch.dict(os.environ, {"TPU_PAGED_V3": "0"}):
            cross_check(torch, details, "llama3.1", 4, "int8")
        with mock.patch.dict(os.environ, {"TPU_PAGED_V4": "1"}):
            cross_check(torch, details, "phi3", 8, "int8")
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
        # 7. path 9: the pulled GGUF model, served by the port's processes
        workdir = tempfile.mkdtemp(prefix="chip_smoke_gguf_")
        try:
            launches_by_path[GGUF_PATH] = gguf_phase(torch, details, card,
                                                     workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        print(f"elapsed {time.perf_counter() - t0:.1f} s", flush=True)
    except Exception as e:  # noqa: BLE001 — every phase failure is fatal
        import traceback
        traceback.print_exc()
        return fail(repr(e))
    kernels = []
    for name, e in entries.items():
        e.pop("ok", None)
        # launches over the serving paths, each counted from 0 (per path
        # in launches_by_path)
        e["launches"] = sum(n[name] for n in launches_by_path.values())
        e["launches_by_path"] = {p: n[name]
                                 for p, n in launches_by_path.items()}
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape", "launches_by_path")})
    details["kernels"] = kernels
    write_details(out_dir, details)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
