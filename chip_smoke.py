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
   and its output required bit-equal to this one's wherever that commit
   takes the group; K1, K2 and K3 rows the same); K1 also at
   hd 256 (gemma's chunk, and with gemma2's softcap and a window) and at
   starcoder2's group of 12, and K6, K4, K5 and K2 at that group; the
   GQA (K2) and MHA (K3) decode kernels over the dense slot cache (K2 also
   at the serving lengths and at other head dims, a full group and a
   softcap, and both at other sequence chunks than their wrappers'); the
   int4 (qmm4, llama3.1 shapes) and int8 (qmm, llama3.2:3b shapes, N = 8
   among them, where qmm takes the decode form, and N = 17, the first past
   it; phi3's LM head, O = 32064, and a second ragged O) dequant matmuls.
   Also the tied LM head's f32 product (a bf16 GEMM with an f32 output)
   against the f32 product of the same values.
3. Serving, eight paths, each at full width behind the port's HTTP
   server on an ephemeral port (path 1 at full depth, paths 2-8 cut to 4
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

8. Path 10, chat and structured output, on path 9's restarted server
   before it stops (``chat_phase``; the GGUF carries a llama3-style
   chat template layer with ``.Messages`` and ``.Tools``, which renders
   /api/generate's bare prompt as it is): (a) 8 concurrent streamed
   /api/chat conversations on a shared 420-word system message, two
   turns each (the second carries the first's answer), 64 greedy tokens;
   each turn's streamed round is timed (TTFT, tok/s, the prompt tokens
   reused and prefilled from ``/api/ps``), then a non-streamed, a
   one-token and a streamed twin of each request, which extend the same
   cached prefix: the streamed twin's text must equal the non-streamed
   one's, its first frame the one-token twin's text, and no response may
   take more than ceil(eval_count / 16) + 2 frames; (b)
   /v1/chat/completions not streamed (its ``usage`` equal to /api/chat's
   counts) and streamed (SSE ending ``data: [DONE]``), /v1/completions,
   /v1/models; (c) ``format: "json"`` and a schema (a string, an integer,
   an enum, an array) on /api/generate, json on /api/chat,
   ``response_format`` json_object and json_schema, each alone and beside
   7 unconstrained requests: every output a prefix the port's automaton or
   schema machine accepts, and a complete JSON value of the schema where
   it stopped; (d) ``tools`` on /api/chat and /v1/chat/completions with a
   schema that forces an invocation (``tool_calls``; ``finish_reason``
   "tool_calls"), streamed and not, and without one. Path 10's K1, K6 and
   K7 counts, read from ``/api/ps`` before and after, must be above 0.
   Then in this process (``grammar_cross_check``): llama3.2:3b at full
   width and two layers, int8 weights, the GGUF's tokenizer, on the paged
   int8 pool and the dense bf16 cache: greedy ``format: "json"`` streams
   with the device grammar table at 64 and at 4 states must equal those
   with host masks (``TPU_GRAMMAR_DEVICE=0``), and the 4-state table
   must be left at least once; the token-table and grammar-table build
   times on this host are printed. Path 1's decode step
   (``step_breakdown``) is also taken with slot 0 on a device-table JSON
   grammar.

9. Path 11, the operator's pod lifecycle (``lifecycle_phase``), on a
   third start of path 9's server from the transcode cache with
   ``--max-slots 4``, ``TPU_TENANT_MAX_QUEUED=2`` and
   ``TPU_DRAIN_TIMEOUT_S=30``: (a) ``/healthz``, ``/livez`` and
   ``/readyz`` answer 200 after preload, ``/metrics`` parses as
   Prometheus text with the request, token, shed and dispatch-histogram
   families, and ``/api/ps`` carries ``admission``, ``lifecycle``
   ("serving") and ``utilization`` (the card's peak, an MFU between 0 and
   1); (b) ``deadline_ms`` 300 with ``num_predict`` 512 ends with
   ``done_reason`` "timeout" and partial output, and a queued request
   whose 200 ms deadline passes gets 503 with ``Retry-After``; (c) four
   ``high`` requests sent behind eight queued ``best_effort`` ones (128
   tokens each; a best_effort stream is dropped after its first frame):
   the TTFT median and max by class are printed, and the high median must
   be below the best_effort median; (d) a third queued request of
   ``X-Tenant: a`` gets 429 with ``Retry-After``, and one with
   ``ttft_slo_ms`` 1 behind that backlog 503 with ``Retry-After``; (e)
   ``options.trace`` puts ``timings`` in the final frame, served in full
   by ``/debug/trace?id=``, and ``/debug/events`` serves the flight
   recorder's ring; (f) bad ``deadline_ms``, ``priority`` and
   ``ttft_slo_ms`` values answer 400 with the reference's messages, and
   ``disagg_prefill`` 400; (g) SIGTERM while four streams run:
   ``/readyz`` answers 503 "draining" while ``/livez`` answers 200, a new
   request 503 with ``Retry-After``, each stream ends with its done frame
   (or a "drain" frame at the timeout), and the process exits 0 within
   40 s; the drain time is printed. K1, K6 and K7 counts from ``/api/ps``
   must be above 0. Then in this process (``replay_cross_check``, (h)):
   llama3.2:3b at full width and two layers, int8 weights, the paged int8
   pool, ``TPU_DISPATCH_WATCHDOG_MS=500``: four greedy and two seeded
   streams run unfailed, then again with one dispatch wait wedged 2 s
   through the ``engine.watchdog`` fault point mid-stream; the watchdog
   fires, the scheduler restarts and replays all six through K1, none
   ends with an error frame, and a greedy stream's tokens must equal the
   unfailed run's up to a divergence at a near-tie (the tokens after it
   are counted as not decidable); the restart and replay times are
   printed.

10. Path 12, gemma3 at full width and 12 of its 34 layers
    (``gemma3_phase``; ``GEMMA3_LAYERS``, cut for the run's time: layers
    5 and 11 attend in full; dim 2560, 8/4 heads, hd 256, tied vocab
    262208, random bf16
    weights from the seed through ``ModelManager.preload``, which serves
    int8 weights (K7), on the server's int8 paged pool, 64 slots of
    128-row pages): 4 raw /api/generate requests (one of 1500 tokens,
    past the sliding layers' 1024 window and admitted in six pieces) and
    4 two-turn /api/chat conversations through the gemma template,
    greedy, 32 tokens each; qmm's count above 0 and every attention
    kernel's 0 (alternating windows attend through the einsum); tok/s,
    TTFT, the decode step (``step_breakdown``), peak memory; then the
    long request's calls replayed teacher-forced on the kernel path
    (``teacher_forced``), whose tokens must equal the served ones at
    every step. Then the other families' two-layer, full-width
    cross-checks, kernel path against plain path (``FAMILY_CHECKS``:
    mixture of experts first, with bf16 experts, and each check's router
    choices compared token by token (``router_flips``; a flip not
    explained by a near-tie fails it; the plain path takes the kernel
    path's experts, as it takes its tokens): qwen3moe at qwen3:30b-a3b's widths
    on the bf16 dense cache through K1 and K2 (G 8), qwen2moe at
    Qwen1.5-MoE-A2.7B's (shared expert, attention biases) with
    ``TPU_MHA_KERNEL=1`` through K1 and K3, and mixtral with int4
    attention projections through K1, K2 and K8; then gemma3 at a
    1500-token prompt, cut to one sliding and one
    full-attention layer with the global rope; qwen3 int4 through K1,
    K6, K8; gemma2 int4 at a 4200-token prompt; starcoder2 int8 at its
    group of 12 through K6, K4, K5 and, on the dense bf16 cache, K2; phi
    int8 at hd 80; gemma int4 through K1 at hd 256), each kernel's count
    above 0.

11. Path 13, qwen3moe (qwen3:30b-a3b) at full width and depth
    (``moe_phase``; 48 layers, dim 2048, 32/4 heads, hd 128, qk-norm, 128
    experts of 768, top-8 renormalised, untied vocab 151936: 30.53e9
    parameters, 61.06 GB of random bf16 weights from the seed, made on
    the card one slice at a time) through ``ModelManager.preload``, which
    serves it in bf16 on the dense int8 slot cache (8 slots, as the JAX
    package serves MoE), behind the HTTP server: 8 concurrent greedy raw
    /api/generate requests of 96-316 prompt tokens (two of them in two
    256-token pieces) and 32 tokens, then a repeat over a parked prefix;
    K1's count above 0, every other kernel's 0 (the int8 dense cache
    decodes through ``attend_hf_q``); tok/s, TTFT, the memory allocated
    before and the peak after, the decode step (``step_breakdown``), and
    the longest and shortest request's served tokens against the engine's
    calls for them replayed teacher-forced on the card
    (``dense_replay``), equal at every step. Phase 2 also times one
    qwen3moe MoE layer (``moe_layer_times``: N = 8 and 256, not a TPU
    kernel) against its bound.

Path 14 (embeddings): (a) on path 9's restarted server,
after path 10, /api/embed of 64 texts of 20..500 tokens (length buckets
32..512, each one padded batch: K1 and K7 at up to 64 x 512 rows), K1's
and K7's /api/ps counts above 0; one text through /api/embed,
/api/embeddings and /v1/embeddings beside 8 generate streams, the three
vectors equal and within cosine 0.999 of its batch row; (c) on the same
server, mxbai-embed-large at full width and depth (24 layers, dim 1024,
a 0.67 GB f16 BERT GGUF written from the seed) uploaded through
/api/blobs, created by ``files``, copied, shown, loaded, /api/embed of 64
texts (some cut at 512 tokens), /api/generate 400, and 4 texts' vectors
within cosine 0.9999 of the port's f32 forward of the same GGUF on the
CPU; (b) after paths 9-11, two-layer full-width embedding cross-checks
(llama3.1 int4, llama3.2:3b int8, a [32, 512] batch: K8 and K7 at 16384
rows) of the kernel path against the plain path, and kernel rows for K1
and K7 at (a)'s largest bucket and K8 at (b)'s; (d) in path 13, one
embed of 8 texts on the full qwen3moe. Each part's seconds are printed
and recorded (``embed_path.elapsed_s``).

Path 15 (images, adapters, mirostat): (c) on path 9's restarted server
after path 10, 2 seeded requests each of mirostat 1 and 2 (tau 5, eta
0.1, 64 tokens), each repeating itself, and (b) after path 14, a rank-16
LoRA GGUF from the seed for the seven projections of every layer,
uploaded through /api/blobs, created with ``FROM`` path 9's model and
``ADAPTER``, loaded (merged at load, then int8 through K7): its seeded
streams differ from the base model's; after the servers stop, in this
process, the mirostat streams replayed teacher-forced with the
truncation recomputed at every step (every token inside it; the mean
surprise of the last 32), and the tuned streams replayed teacher-forced
on the adapter merged on the card, which the port's ``apply_lora``
equals on the first and last layers; (a) last, llava at full width and
depth (int4, K8; its 32/32 heads at hd 128 through K1 and K6) with a
CLIP ViT-L/14-336 tower from an mmproj GGUF written from the seed: 8
/api/generate requests of one PNG each and 2 /api/chat of two, beside
their text twins (576 prompt tokens an image), two of them replayed
teacher-forced on their recorded spliced embeddings, a two-layer
kernel-against-plain cross-check fed those embeddings, the bf16 tower
against its f32 weights (cosine >= 0.999 a row). Seconds in
``path15.elapsed_s``. An early line says whether Pillow imports (PNGs
decode without it).

Then it prints one JSON line ``{"kernels": [...]}`` (``launches`` summed
over the serving paths, per path in ``launches_by_path``), the
``nvidia-smi`` line, and as the last line ``{"ok": true, "device":
{...}}``. With ``--out DIR`` the details (``chip_smoke.json``) and the
compiler's register report (``ptxas.txt``) are written to DIR;
``--kernels-only`` stops after phase 2; ``--gguf-only`` runs phase 1 and
then phases 7, 8 and 9 alone, ``--families-only`` phase 1 and then phase
10 alone, ``--moe-only`` phase 1, the MoE layer, the MoE cross-checks and
phase 11 alone, ``--drift`` phase 1 and then gemma3's logit differences at 2,
6, 12 and 34 layers (``drift_sweep``), ``--embed-only`` phase 1 and then
path 14 alone (its server's model uploaded and created instead of
pulled, (d) on qwen3moe cut to 4 layers), ``--vision-only`` phase 1 and
then path 15 alone ((a) first; (b) and (c) on an uploaded and created
model) (each exits 4 by design: no result line).
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
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
import urllib.error
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
# head dims of the served models (llama, qwen3, starcoder2 128, phi3 96,
# gemma2/gemma3/gemma 256, phi 80): the paged kernels must run each on
# their tensor-core path
SERVED_HEAD_DIMS = (128, 96, 256, 80)
# the mixture-of-experts families at their published widths, where the
# repo has no preset: qwen3:30b-a3b (Qwen3-30B-A3B: 48 layers, 128 experts
# of 768, top-8 renormalised) and Qwen1.5-MoE-A2.7B (qwen2moe: 60 experts
# of 1408, top-4 as they are, a shared expert of 5632); ffn_dim is the
# experts' width
MOE_CONFIGS = {
    "qwen3moe": dict(vocab_size=151936, dim=2048, n_layers=48, n_heads=32,
                     n_kv_heads=4, head_dim=128, ffn_dim=768, n_experts=128,
                     n_experts_used=8, qk_norm=True, rope_theta=1e6,
                     norm_eps=1e-6, max_seq_len=40960),
    "qwen2moe": dict(vocab_size=151936, dim=2048, n_layers=24, n_heads=16,
                     n_kv_heads=16, head_dim=128, ffn_dim=1408,
                     n_experts=60, n_experts_used=4, moe_renorm=False,
                     n_shared_ffn=5632, attn_bias=True, rope_theta=1e6,
                     norm_eps=1e-6, max_seq_len=8192)}


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


def load_baseline(root: str):
    """The port's package in another checkout at ``root``, imported as
    ``baseline_port`` (its own modules, build directory and launch
    counters), so a call can time that commit beside this one."""
    import importlib.util
    pkg = os.path.join(os.path.abspath(root), "ollama_operator_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "baseline_port", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules["baseline_port"] = mod
    spec.loader.exec_module(mod)
    return mod


def load_baseline_paged(root: str):
    """``ops/paged.py`` of the port in another checkout at ``root``, so a
    call can time that commit's paged kernels beside this one's; its
    ``ops/attention.py`` (K1, K2, K3) is ``baseline_port.ops.attention``."""
    import importlib
    load_baseline(root)
    return importlib.import_module("baseline_port.ops.paged")


def kernel_phases(torch, timer, report, baseline=None):
    import importlib

    import torch.nn.functional as F
    from ollama_operator_tpu_torch.ops import attention as A
    from ollama_operator_tpu_torch.ops import paged as PG
    from ollama_operator_tpu_torch.ops import quant as Q
    from ollama_operator_tpu_torch.ops.quant_cache import pool_bits
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev, bf = "cuda", torch.bfloat16
    base_a = (importlib.import_module("baseline_port.ops.attention")
              if baseline is not None else None)

    def against_base(fn, base_fn, out):
        """With a baseline commit: its kernel's time and host time on the
        same inputs, and whether its output has the same bits (required:
        every kernel the baseline also takes keeps its bits)."""
        if base_a is None:
            return None
        same = torch.equal(base_fn(), out)
        if not same:
            raise RuntimeError("a kernel's output differs from the "
                               "baseline commit's on the same inputs")
        return dict(ms=timer(base_fn), host_us=timer.host_us(base_fn),
                    bit_equal=same)

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
                                             f"hd={hd}", main=(H == 32),
               baseline=against_base(
                   lambda: A.flash_prefill(q, k, v, scale),
                   base_a and (lambda: base_a.flash_prefill(q, k, v,
                                                            scale)), out))

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
                     f"softcap={softcap} (ragged)", main=False,
               baseline=against_base(
                   lambda: A.flash_prefill(*args),
                   base_a and (lambda: base_a.flash_prefill(*args)), out))
        del q, k, v, out, ref, band, qh, kr, vr

    # -- flash prefill at the head dims and groups the other families
    # bring: gemma's prefill chunk (MHA 16/16, hd 256; K1 above
    # hd 128 keeps Q in shared memory and walks 32-key tiles), hd 256 with
    # GQA, gemma2's softcap 50 and a 128-key window, starcoder2's heads
    # (24 over 2 kv heads, G = 12) under its 4096 window (T = 512: it does
    # not bite), and qwen3moe's 256-token piece (32 over 4 kv heads). SDPA
    # has no softcap: no library time there
    for B, T, H, KvH, hd, window, softcap, what in (
            (1, 512, 16, 16, 256, 0, 0.0, "gemma"),
            (1, 512, 16, 8, 256, 128, 50.0, "hd 256, softcap, window"),
            (1, 512, 24, 2, 128, 4096, 0.0, "starcoder2, G 12"),
            (1, 256, 32, 4, 128, 0, 0.0, "qwen3moe's chunk, G 8"),
            (1, 1024, 32, 32, 128, 0, 0.0, "llava's image admission, MHA")):
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
                     f"softcap={softcap} ({what})", main=False)
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
            # the baseline commit's kernels take groups up to 8
            if baseline is not None and H // KvH <= 8:
                old = getattr(baseline, f"paged_decode_attention_{route}")
                same = torch.equal(old(*args, nblk=nblk), out)
                extra["baseline"] = dict(
                    ms=timer(lambda: old(*args, nblk=nblk)),
                    host_us=timer.host_us(lambda: old(*args, nblk=nblk)),
                    bit_equal=same)
                if not same:
                    raise RuntimeError(f"the {route} kernel's output "
                                       f"differs from the baseline "
                                       f"commit's")
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
    # starcoder2's heads (H=24 over KvH=2, G = 12: two n8 query tiles of the
    # tensor-core loop): int8 through K6, K4 and K5, int4 and bf16
    # through K6
    paged_case(64, 128, 32, 24, 2, 128, 8, 2048, 0, ())
    paged_case(64, 128, 32, 24, 2, 128, 4, 2048, 0, (), routes=("v3",))
    paged_case(64, 128, 32, 24, 2, 128, 16, 2048, 0, (), routes=("v3",))
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
    # llava (path 15): MHA at hd 128 (G = 1) on its 64-row pages, 32
    # slots, over 1..4095 and at a serving step of 12 requests of
    # 600..1250 positions (image prompts of 576 image tokens and more)
    paged_case(32, 64, 64, 32, 32, 128, 8, 4095, 0, (), routes=("v3",))
    paged_case(32, 64, 64, 32, 32, 128, 8, 1250, 0, (), routes=("v3",),
               serving=True, idle=20)
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
    # starcoder2's heads on the dense cache (G = 12: rows 8 .. 15 of the
    # 16-row tile are query rows too), with no window and with a
    # 2047-row one
    for window in (0, 2047):
        dense_cases.append(("decode_attention", 24, 2, 128, window, 0.0,
                            spread, False, None))
    # qwen3moe's heads on its dense cache (32 over 4 kv heads, G = 8)
    dense_cases.append(("decode_attention", 32, 4, 128, 0, 0.0, spread,
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
               main=main, host_us=timer.host_us(lambda: fn(*args)),
               # the baseline commit's kernels take groups up to 8, at its
               # own chunk (rows with a chunk knob are not compared)
               baseline=against_base(
                   lambda: fn(*args),
                   base_a and (lambda: getattr(base_a, fn.__name__)(*args)),
                   out) if G <= 8 and not knob else None)
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
    # -- the dequant matmuls at the projections the other dense families
    # bring, at the decode step's rows: K7 at gemma3's (D 2560, q
    # 2048, kv 1024, F 10240), starcoder2's kv (O = 256) and phi's untied
    # head (O = 51200, N = 32 slots); K8 at gemma2's (D 3584, q 4096, kv
    # 2048, F 14336) and qwen3's head (O = 151936)
    for name, fn, plain, quant, replaces, shapes in (
            ("qmm", Q.qmm, Q.qmm_plain, Q.quantize_groupwise,
             "ollama_operator_tpu/ops/pallas/quant.py:73",
             (("gemma3 wq", 64, 2560, 2048), ("gemma3 wk/wv", 64, 2560, 1024),
              ("gemma3 wo", 64, 2048, 2560),
              ("gemma3 w_gate/w_up", 64, 2560, 10240),
              ("gemma3 w_down", 64, 10240, 2560),
              ("starcoder2 wk/wv", 64, 3072, 256),
              ("phi lm_head", 32, 2560, 51200))),
            ("qmm4", Q.qmm4, Q.qmm4_plain, Q.quantize_groupwise_int4,
             "ollama_operator_tpu/ops/pallas/quant.py:142",
             (("gemma2 wq", 64, 3584, 4096), ("gemma2 wk/wv", 64, 3584, 2048),
              ("gemma2 wo", 64, 4096, 3584),
              ("gemma2 w_gate/w_up", 64, 3584, 14336),
              ("gemma2 w_down", 64, 14336, 3584),
              ("qwen3 lm_head", 64, 4096, 151936))
             # llava's (path 15): F 11008 (w_down's K = 344 groups of 32),
             # the 32000-row head; N = 1 and 64 as a decode step (32
             # slots), 1024 as an image admission's bucket
             + tuple((f"llava {w}", N, K, O) for N in (1, 64, 1024)
                     for w, K, O in (("w_gate/w_up", 4096, 11008),
                                     ("w_down", 11008, 4096),
                                     ("lm_head", 4096, 32000))))):
        for wname, N, K, O in shapes:
            qw = quant(torch.randn((K, O), generator=g, device=dev) * 0.02)
            codes = qw["q4"] if "q4" in qw else qw["q"]
            wbf = Q.dequantize_groupwise(qw).to(bf)
            x = randn(N, K)
            out, ref = fn(x, codes, qw["s"]), plain(x, codes, qw["s"])
            report(name, f"csrc/{name}.cu", replaces,
                   ((out - ref).abs().max().item(), 1e-3),
                   timer(lambda: fn(x, codes, qw["s"])),
                   timer(lambda: plain(x, codes, qw["s"])),
                   timer(lambda: torch.matmul(x, wbf)),
                   *bound(2 * N * K + codes.numel() + 4 * (K // 32) * O
                          + 4 * N * O, 2.0 * N * K * O),
                   shape=f"{wname} N={N} K={K} O={O}", main=False)
            del qw, codes, wbf
    torch.cuda.empty_cache()


def byte_tokenizer(vocab: int, bos=None):
    """256 byte pieces (every text encodes, one token per byte) and plain
    filler pieces up to the model's vocabulary; no EOG id, so every
    request runs to num_predict; a BOS id ``bos`` put before every
    prompt when one is given."""
    from ollama_operator_tpu_torch.tokenizer import Tokenizer
    tokens = [f"<0x{i:02X}>" for i in range(256)]
    tokens += [f"t{i}" for i in range(256, vocab)]
    return Tokenizer(model="llama", tokens=tokens,
                     token_types=[6] * 256 + [1] * (vocab - 256),
                     add_bos=bos is not None, bos_id=-1 if bos is None
                     else bos)


def dense_params(torch, cfg):
    """Random dense bf16 weights on the card, from the seed."""
    from ollama_operator_tpu_torch.models import decoder
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = decoder.init_params(cfg, g, torch.bfloat16, "cuda")
    torch.cuda.synchronize()
    return params


def http(port: int, path: str, body=None, timeout: float = 600):
    """One request: (status, frames, arrival seconds of each frame). The
    frames are the NDJSON lines or SSE events of the body, parsed (an SSE
    ``[DONE]`` kept as the string); an error frame raises."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    frames, times = [], []
    t0 = time.perf_counter()
    with urllib.request.urlopen(req, timeout=timeout) as r:
        status = r.status
        for line in r:
            line = line.decode().strip()
            if not line:
                continue
            if line.startswith("data: "):
                line = line[len("data: "):]
            frames.append(line if line == "[DONE]" else json.loads(line))
            times.append(time.perf_counter() - t0)
    bad = [f for f in frames if isinstance(f, dict) and "error" in f]
    if bad:
        raise RuntimeError(f"{path}: server error {bad[0]}")
    return status, frames, times


def concurrent(calls):
    """Run the thunks ``calls`` at once; their results in order, and the
    wall time."""
    out, errors = [None] * len(calls), []

    def run(i):
        try:
            out[i] = calls[i]()
        except Exception as ex:  # noqa: BLE001 — reported below
            errors.append(f"call {i}: {ex!r}")

    t0 = time.perf_counter()
    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(calls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise RuntimeError(f"concurrent calls failed: {errors}")
    return out, time.perf_counter() - t0


def post(port: int, body: dict) -> dict:
    """The last frame of one /api/generate request."""
    return http(port, "/api/generate", body)[1][-1]


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
# depth (phase 5 runs on it); paths 2-8 are cut to 4 layers to keep the
# run inside its time limit (8 since path 9 serves llama3.2:3b, path 2's
# model and cache, at full depth from a GGUF; 4 since path 12 serves
# gemma3 at full depth)
SERVING_LAYERS = (None, 4, 4, 4, 4, 4, 4, 4)


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
        results, wall = concurrent([
            lambda p=p: post(port, {"model": model, "prompt": p,
                                    "options": opts}) for p in prompts])
        launches = dict(cuda_build.launches)
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


def close_serving(torch, details, out, mm, httpd, lm, grammar=False):
    """Stop a serving path's server and model manager; with ``out``, time
    a decode step on its engine (``grammar``: also with one slot on a
    device-table JSON grammar) and record the path."""
    import gc
    httpd.shutdown()
    httpd.server_close()
    mm.shutdown()
    if out is not None:
        # the scheduler has stopped: drive its engine directly
        out["step"] = step_breakdown(
            torch, lm.engine, tokenizer=lm.tokenizer if grammar else None)
        details.setdefault("serving", []).append(out)
    del lm
    gc.collect()
    torch.cuda.empty_cache()


# the steps of step_breakdown's profiled dispatch: the profiler's cost
# grows with the kernels it records (~116 s for 16 steps of path 13's
# 7300 kernels a step on a slow host), so it records fewer steps than the
# timed dispatch (path 13's step took 27.4 s of a run at 4 steps, 12.6
# at 2)
PROFILED_STEPS = 2


def step_breakdown(torch, engine, n_slots: int = 8, n: int = 16,
                   tokenizer=None) -> dict:
    """One decode dispatch of ``n`` steps for ``n_slots`` greedy slots
    (200-token prompts), straight on the engine after its scheduler has
    stopped: the host clock for enqueueing it and for finishing it, and
    the device's busy time from ``torch.profiler`` over a further
    dispatch of ``PROFILED_STEPS`` steps (the kernels' own times; "not
    measured" when the profiler records none). With
    ``tokenizer``, the same dispatch again with slot 0 on a device-table
    JSON grammar (an 8-state ``GrammarTable`` of the tokenizer, the slot
    at its start state): its kernels a step and busy time."""
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
    cuda = getattr(torch.autograd.DeviceType, "CUDA", None)

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    def profiled():
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            engine.decode_n_launch(PROFILED_STEPS).wait()
        return [e for e in prof.key_averages()
                if getattr(e, "device_type", None) == cuda]

    t_prof = time.perf_counter()
    kernels = profiled()
    t_prof = time.perf_counter() - t_prof
    m = PROFILED_STEPS
    busy_ms = sum(dev_us(e) for e in kernels) / 1e3 / m
    by_name = collections.Counter()
    for e in kernels:    # names cut to 100 characters, their times summed
        by_name[e.key[:100]] += dev_us(e) / 1e3 / m
    grammar = None
    if tokenizer is not None:
        from ollama_operator_tpu_torch.ops.constrain import (GrammarTable,
                                                             TokenTable)
        gt = GrammarTable.for_table(TokenTable.for_tokenizer(tokenizer),
                                    cap=8)
        if not engine.install_grammar(("step", id(gt)), gt.mask, gt.trans):
            raise RuntimeError("the engine refused the grammar table")
        engine.set_mask(0, gt.mask[0], gid=0)
        engine.decode_n_launch(4).wait()
        engine.set_mask(0, gt.mask[0], gid=0)
        t0 = time.perf_counter()
        handle = engine.decode_n_launch(n)
        g_enqueue = time.perf_counter() - t0
        handle.wait()
        g_wall = time.perf_counter() - t0
        engine.set_mask(0, gt.mask[0], gid=0)
        gk = profiled()
        g_ms = sum(dev_us(e) for e in gk) / 1e3 / m
        grammar = {"kernel_launches_per_step": (
            sum(e.count for e in gk) / m if gk else "not measured"),
            "device_busy_ms_per_step": g_ms if gk else "not measured",
            "host_enqueue_ms_per_step": g_enqueue * 1e3 / n,
            "wall_ms_per_step": g_wall * 1e3 / n}
    for slot in range(n_slots):
        engine.release(slot)
    out = {"slots": n_slots, "steps": n,
           "host_enqueue_ms_per_step": t_enqueue * 1e3 / n,
           "wall_ms_per_step": t_wall * 1e3 / n,
           "device_busy_ms_per_step": busy_ms if kernels else "not measured",
           "device_busy_share": (busy_ms / (t_wall * 1e3 / n)
                                 if kernels else "not measured"),
           "kernel_launches_per_step": (sum(e.count for e in kernels) / m
                                        if kernels else "not measured"),
           "top_kernels_ms_per_step": dict(by_name.most_common(8)),
           "profiled_dispatch_s": t_prof,
           "one_slot_on_a_json_grammar": grammar}
    print(f"decode step ({n_slots} slots, {n} steps): host enqueue "
          f"{out['host_enqueue_ms_per_step']:.2f} ms/step, wall "
          f"{out['wall_ms_per_step']:.2f} ms/step, device busy "
          f"{out['device_busy_ms_per_step']} ms/step, launches/step "
          f"{out['kernel_launches_per_step']}"
          + (f"; with slot 0 on a device-table json grammar: launches/step "
             f"{grammar['kernel_launches_per_step']}, device busy "
             f"{grammar['device_busy_ms_per_step']} ms/step, host enqueue "
             f"{grammar['host_enqueue_ms_per_step']:.2f} ms/step, wall "
             f"{grammar['wall_ms_per_step']:.2f} ms/step"
             if grammar else ""), flush=True)
    return out


def plain_matmul(x, w, out_dtype=None, split: int = 1):
    """``quant.matmul`` with the dequant matmuls on their plain versions
    (``qmm_plain``, ``qmm4_plain``). ``split`` > 1 (int8 only) sums an
    int8 product over that many slices of K in f32: the same function,
    its sums in another order (the drift sweep's control)."""
    from ollama_operator_tpu_torch.ops import quant as Q
    if not Q.is_quantized(w):
        y = x @ w
        return y.to(out_dtype) if out_dtype is not None else y
    x2 = x.reshape(-1, x.shape[-1])
    if Q.is_int4(w):
        assert split == 1, "the split control is int8 only"
        y = Q.qmm4_plain(x2, w["q4"], w["s"])
    else:
        K = x2.shape[1]
        cut = [K * i // split // Q.GROUP * Q.GROUP for i in range(split + 1)]
        y = sum(Q.qmm_plain(x2[:, a:b], w["q"][a:b],
                            w["s"][a // Q.GROUP:b // Q.GROUP])
                for a, b in zip(cut, cut[1:]))
    return y.reshape(*x.shape[:-1], -1).to(out_dtype or x.dtype)


def teacher_forced(torch, cfg, params, ids, steps: int, kv_dtype: str,
                   paged: bool = True, teacher=None, engine=None,
                   piece: int = 0, embeds=None):
    """A prompt ``ids`` and ``steps`` decode steps on the card through the
    decoder's entry points, each step fed ``teacher[step]`` or else the
    previous step's argmax. Returns (logits [steps + 1, V] f32, their
    argmax tokens).

    Without ``engine``: the prompt in one ``prefill_chunk`` (padded to a
    multiple of 256), then steps in a batch of one, on shuffled 128-row
    pages of a ``kv_dtype`` pool (``paged``) or in a dense slot of twice
    the prompt's bucket. With ``engine`` (paged): the calls that engine
    made for a request admitted from position 0: the prompt in
    ``piece``-token pieces (the first a prefill and an insert, the others
    extends, each padded to the engine's bucket; the LM head over the
    last prompt row alone, as the engine's admission samples it), then
    steps in a batch of the engine's slot count (row 0; the other rows
    idle on the trash page), so every matmul takes the row count, and so
    the form, that the served one took. ``embeds`` [n, D]: the prompt's
    spliced embeddings (a multimodal admission, whole: ``ids`` carry the
    pad id at image positions), prefilled in place of the lookup."""
    from ollama_operator_tpu_torch.models import decoder
    dev, n = "cuda", len(ids)
    L, KvH, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    if engine is None:
        ps, rows, width, piece = 128, 1, 32, n

        def bucket_for(m):
            return -(-m // 256) * 256
    else:
        ps, rows = engine.ecfg.page_size, engine.n_slots
        width, bucket_for = engine.max_seq // ps, engine.bucket_for
    first = min(piece, n)
    bucket = bucket_for(first)
    # the blocks of the prompt, the steps and (engine) the last piece's
    # padding, in a shuffled order of the pool's pages (page 0 the trash
    # page); the table also covers the first piece's bucket, whose padding
    # positions paged_insert sends through it to the trash page
    nb = -(-(n + steps + 1 + (piece if engine is not None else 0)) // ps)
    P = nb + 3
    shp = ((L, P, KvH, ps, hd) if paged
           else (L, 1, KvH, 2 * bucket, hd))

    def pool():
        if kv_dtype == "int4":
            return {"q4": torch.zeros(shp[:3] + (ps // 2, hd),
                                      dtype=torch.uint8, device=dev),
                    "s": torch.zeros(shp[:-1], device=dev)}
        if kv_dtype == "int8":
            return {"q": torch.zeros(shp, dtype=torch.int8, device=dev),
                    "s": torch.zeros(shp[:-1], device=dev)}
        return torch.zeros(shp, dtype=torch.bfloat16, device=dev)

    def padded(toks):
        out = torch.zeros((1, bucket_for(len(toks))), dtype=torch.long,
                          device=dev)
        out[0, :len(toks)] = torch.tensor(toks, device=dev)
        return out
    kp, vp = pool(), pool()
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    tables = torch.zeros((rows, max(width, nb, -(-bucket // ps))),
                         dtype=torch.int32, device=dev)
    tables[0, :nb] = (torch.randperm(P - 1, generator=gen)[:nb] + 1).int()
    emb = None
    if embeds is not None:
        if first != n:
            raise ValueError("a multimodal prompt is admitted whole")
        emb = torch.zeros((1, bucket, embeds.shape[-1]), dtype=embeds.dtype,
                          device=dev)
        emb[0, :n] = embeds
    if engine is not None or emb is not None:
        x, ks, vs = decoder.prefill_hidden(params, cfg, padded(ids[:first]),
                                           inputs_embeds=emb)
        last = decoder._unembed(cfg, params, x[:, first - 1])[0]
    else:
        logits, ks, vs = decoder.prefill_chunk(params, cfg,
                                               padded(ids[:first]))
        last = logits[0, first - 1]
    if paged:
        decoder.paged_insert(cfg, kp, vp, ks, vs, tables[0], first)
    else:
        decoder.dense_insert(kp, vp, ks, vs, 0)
    for start in range(first, n, piece):
        tail = ids[start:start + piece]
        toks = padded(tail)
        x, _, _ = decoder.forward_with_cache_paged(
            params, cfg, toks, kp, vp, tables[:1],
            torch.tensor([start], dtype=torch.int32, device=dev),
            -(-bucket_for(start + toks.shape[1]) // ps), hidden=True)
        last = decoder._unembed(cfg, params, x[:, len(tail) - 1])[0]
    out = [last]
    lengths = torch.zeros(rows, dtype=torch.int32, device=dev)
    toks = torch.zeros((rows, 1), dtype=torch.long, device=dev)
    for step in range(steps):
        lengths[0] = n + step
        toks[0, 0] = (out[-1].argmax() if teacher is None
                      else int(teacher[step]))
        if paged:
            lg, _, _ = decoder.forward_with_cache_paged(
                params, cfg, toks, kp, vp, tables, lengths, nb)
        else:
            lg, _, _ = decoder.forward_with_cache(
                params, cfg, toks, kp, vp, lengths, attn_len=bucket)
        out.append(lg[0, 0])
    out = torch.stack(out).float()
    return out, [int(t) for t in out.argmax(-1)]


def model_config(name: str):
    """A preset's config, or one of ``MOE_CONFIGS`` (no preset)."""
    from ollama_operator_tpu_torch.models.config import (ModelConfig,
                                                         get_config)
    if name in MOE_CONFIGS:
        return ModelConfig(arch="llama", **MOE_CONFIGS[name]).validate()
    return get_config(name)


def router_flips(cfg, kernel, plain) -> dict:
    """The tokens whose selected experts differ between the kernel path's
    router calls and the plain path's (the same calls, in order: a
    layer's prefill or step), each call's rows a token. A flip is
    explained when, at that token, the plain path's gap between its k-th
    and (k+1)-th router logits is no wider than the largest difference
    between two experts' moves from the plain path's logits to the kernel
    path's (max - min of the logits' differences): an expert a can
    overtake an expert b only where its logit rose by at least their gap
    more than b's did."""
    k = cfg.n_experts_used
    flips = explained = tokens = 0
    worst = []
    for (lk, ik), (lp, ip) in zip(kernel, plain):
        tokens += ik.shape[0]
        rows = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
        if not rows.any():
            continue
        top = lp[rows].topk(k + 1, dim=-1).values
        gap = top[:, k - 1] - top[:, k]
        d = lk[rows] - lp[rows]
        diff = d.amax(-1) - d.amin(-1)
        flips += int(rows.sum())
        explained += int((gap <= diff).sum())
        worst += [(g, d) for g, d in zip(gap.tolist(), diff.tolist())]
    return {"token_layers": tokens, "flips": flips, "explained": explained,
            "gap_and_logit_diff": worst[:16]}


def cross_check(torch, details, model: str, bits: int, kv_dtype: str,
                paged: bool = True, n_prompt: int = 200, expect=(),
                cut=None, ids=None, embeds=None):
    """Two layers (or the config fields ``cut`` sets) at full width:
    kernel path vs plain path on the card, ``bits``-bit weights (16:
    dense bf16) on a ``kv_dtype`` page pool (``paged``) or dense slot
    cache, an ``n_prompt``-token prompt (or the prompt ``ids`` with its
    spliced ``embeds``, a multimodal admission) and 16 greedy steps
    (``teacher_forced``; the plain path is fed the kernel path's tokens).
    ``expect``: the kernel counters the kernel path must raise above 0
    (counted from 0 just before it). A mixture-of-experts model's plain
    path takes the kernel path's experts, and the router choices of the
    two are compared (``router_flips``): an unexplained flip fails the
    check."""
    from ollama_operator_tpu_torch.models import decoder
    from ollama_operator_tpu_torch.ops import attention as A
    from ollama_operator_tpu_torch.ops import paged as PG
    from ollama_operator_tpu_torch.ops import quant as Q
    cfg = dataclasses.replace(model_config(model),
                              **(cut or {"n_layers": 2}))
    layers = cfg.n_layers
    params = dense_params(torch, cfg)
    if bits != 16:
        params = Q.quantize_params(params, bits=bits)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    if ids is None:
        ids = torch.randint(0, cfg.vocab_size, (n_prompt,),
                            generator=gen).tolist()
    n_prompt = len(ids)

    def plain_chunk(cfg, q, k, v, scale):
        return A.flash_prefill_plain(q, k, v, scale, cfg.attn_softcap,
                                     cfg.sliding_window)

    plain_fns = {"flash_prefill": (decoder, "chunk_attention", plain_chunk)}
    if bits != 16:
        plain_fns["qmm4" if bits == 4 else "qmm"] = (Q, "matmul",
                                                     plain_matmul)
    if paged:
        plain_fns["paged_decode"] = (decoder, "paged_decode_attention",
                                     PG.paged_decode_attention_plain)
    else:
        plain_fns["decode_attention"] = (A, "decode_attention",
                                         A.decode_attention_plain)
        plain_fns["mha_decode"] = (A, "mha_decode_attention",
                                   A.mha_decode_attention_plain)

    route = decoder._moe_route

    def run(plain=(), teacher=None, routes=None, forced=None):
        """``teacher_forced`` with the names in ``plain`` on their plain
        versions; each router call's (logits, its own top-k experts)
        appended to ``routes``. With ``forced`` (the kernel path's
        ``routes``) each router call takes the experts the kernel path's
        same call chose, gated from this path's own logits: as the plain
        path is fed the kernel path's tokens, it is fed its routing, so
        that a near-tie flip of an expert (counted by ``router_flips``)
        does not stand in for the kernels' difference."""
        saved = {n: getattr(m, a) for n, (m, a, _) in plain_fns.items()}
        for n in plain:
            m, a, f = plain_fns[n]
            setattr(m, a, f)
        calls = iter(forced or ())

        def recorded(c, lp, xf):
            topw, topi = route(c, lp, xf)
            logits = decoder._mm_f32(xf, lp["router"])
            if routes is not None:
                routes.append((logits, topi))
            if forced is not None:
                topi = next(calls)[1]
                topw = (torch.softmax(logits.gather(1, topi), dim=-1)
                        if c.moe_renorm else
                        torch.softmax(logits, dim=-1).gather(1, topi))
            return topw, topi
        if routes is not None or forced is not None:
            decoder._moe_route = recorded
        try:
            return teacher_forced(torch, cfg, params, ids, 16, kv_dtype,
                                  paged=paged, teacher=teacher,
                                  embeds=embeds)
        finally:
            decoder._moe_route = route
            for n, (m, a, _) in plain_fns.items():
                setattr(m, a, saved[n])

    from ollama_operator_tpu_torch.ops import cuda_build
    moe = bool(cfg.n_experts)
    rk, rp = ([], []) if moe else (None, None)
    for name in cuda_build.launches:
        cuda_build.launches[name] = 0
    lk, sk = run(routes=rk)
    launched = {k: v for k, v in cuda_build.launches.items() if v}
    missing = [k for k in expect if launched.get(k, 0) <= 0]
    if missing:
        raise RuntimeError(f"cross-check of {model}: kernels not launched "
                           f"{missing} ({launched})")
    # the plain path is fed the kernel path's tokens, so both see the same
    # inputs at every step
    lp, sp = run(plain=tuple(plain_fns), teacher=sk, routes=rp, forced=rk)
    flips = router_flips(cfg, rk, rp) if moe else None
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
    proute = PG.paged_route() if paged else None
    weights = "bf16" if bits == 16 else f"int{bits}"
    tag = (f"{model} {weights} weights, {kv_dtype} "
           f"{f'paged ({proute})' if paged else 'dense'} KV"
           + (", spliced image embeddings" if embeds is not None else ""))
    details.setdefault("cross_check", []).append({
        "model": model, "layers": layers, "weights": weights,
        "kv": kv_dtype, "paged": paged, "route": proute,
        "kernels": sorted(plain_fns), "router_flips": flips,
        "prompt_tokens": n_prompt, "launches": launched,
        "logit_max_abs_err": err, "logit_scale": scale, "tol": tol,
        "step_err": step_err, "plain_top2_gap": gaps,
        "near_tie_steps": ties, "kernel_tokens": sk, "plain_tokens": sp})
    print(f"cross-check {tag} ({layers} layers, full width, "
          f"{n_prompt}-token prompt, 17 steps; launches {launched}): "
          f"logits max "
          f"|err| {err:.4g} (tol {tol:.4g}, max |logit| {scale:.4g}); per "
          f"step {[round(e, 4) for e in step_err]}; tokens equal at "
          f"{sum(a == b for a, b in zip(sk, sp))}/{len(sk)} steps; "
          f"near-tie steps {ties} (gaps {[round(gaps[i], 4) for i in ties]})"
          + ("" if flips is None else
             f"; router flips {flips['flips']} of {flips['token_layers']} "
             f"token-layers, {flips['explained']} explained by a gap no "
             f"wider than two experts' logit moves"), flush=True)
    if flips and flips["explained"] < flips["flips"]:
        raise RuntimeError(f"cross-check of {model}: router flips not "
                           f"explained by a near-tie ({flips})")
    if bad or not err <= tol:
        # which kernel's plain version alone moves the kernel path?
        for name in plain_fns:
            lx, _ = run(plain=(name,), teacher=sk, forced=rk)
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
    shared, _ = concurrent([lambda p=p: run(p, 32) for p in prompts])
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
        # 14 dispatches: the 12 pieces need 11 between them and one
        # before, so the decoders outlast them by one or two
        n_dec = 14 * 32
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
# path 9's gate holds this many of its 8 prompts' served streams to an
# in-process load of the same tree (not all 8, for the run's time)
GATE = 4
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

    def __init__(self, args, log_path: str, env=None):
        self.port = free_port()
        self.log = open(log_path, "w+")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", "ollama_operator_tpu_torch.server",
             "--host", "127.0.0.1", "--port", str(self.port)] + args,
            cwd=os.path.dirname(os.path.abspath(__file__)),
            env=dict(child_env(), **(env or {})), stdout=self.log,
            stderr=subprocess.STDOUT)

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


def gguf_phase(torch, details, card: str, workdir: str):
    """Path 9: write llama3.2:3b (full width and depth) as a GGUF from the
    seed, serve it from a loopback registry, pull it with the port's
    store server (``--store-only``) and pull CLI, load it with the port's
    model server (``--preload``: read, dequantized, transcoded and cached,
    then int8 weights, an int8 paged pool), serve 8 concurrent greedy
    requests, restart the server to load from the transcode cache, and
    hold its greedy streams of ``GATE`` prompts against
    ``ModelManager.preload`` of the same ``load_model`` tree in this
    process; path 10 (``chat_phase``) runs on
    the restarted server before it stops, then path 14 (a) and (c)
    (``embed_server_phases``), with path 15 (c) (``mirostat_phase``)
    after path 10 and (b) (``adapter_phase``) after path 14; their checks
    run in this process after the gate (``mirostat_adapter_checks``). Returns the launch counts of path 9's 8
    requests, of path 10, of path 11 and of path 14 (a), each read from
    the server's /api/ps just before and just after them, and the GGUF's
    tokenizer."""
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
    gguf_tok = gguf_tokenizer(g["path"])
    for name, text in (("template", CHAT_TEMPLATE),
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
        results, wall = concurrent([
            lambda p=p: post(ms.port, {"model": ref, "prompt": p,
                                       "options": opts}) for p in prompts])
        after = ms.launches()
        launches = {k: after[k] - before[k] for k in after}
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
        # the gate's streams: the first GATE prompts
        served = [post(ms2.port, {"model": ref, "prompt": p,
                                      "stream": False, "options": opts})
                  for p in prompts[:GATE]]
        # path 10 on the same server, then path 15 (c)
        chat = chat_phase(card, ms2, ref)
        t0 = time.perf_counter()
        p15 = mirostat_phase(card, ms2, ref, cfg)
        p15_el = {"c_server": time.perf_counter() - t0}
        # path 14 (a) and (c) on the same server
        emb = embed_server_phases(torch, details, card, ms2, ref, gguf_tok,
                                  workdir)
        # path 15 (b) on the same server
        t0 = time.perf_counter()
        p15.update(adapter_phase(card, ms2, ref, workdir, store, cfg,
                                 p15["base"]))
        p15_el["b_server"] = time.perf_counter() - t0
        if ms2.stop() != 0:
            raise RuntimeError(f"model server stopped badly: {ms2.tail()}")
        # path 11 on a third start (from the cache), with 4 slots; it
        # ends with the server's SIGTERM
        ms3 = PortServer(args + ["--max-slots", "4"],
                         os.path.join(workdir, "model3.log"), env=LIFE_ENV)
        servers.append(ms3)
        out["load_lifecycle_server_s"] = ms3.wait_ready()
        life = lifecycle_phase(card, ms3, ref)
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
    tokenizer = Tokenizer.from_gguf_metadata(tok_md)
    lm = mm.preload(GGUF_MODEL, gcfg, params_from_numpy(params, "cuda"),
                    tokenizer, dtype="int8", template=CHAT_TEMPLATE,
                    ecfg=ecfg)
    del params
    out["preload_s"] = time.perf_counter() - t0
    try:
        if (lm.ecfg != ecfg or gcfg.n_params != cfg.n_params
                or lm.serving_dtype != "int8"):
            raise RuntimeError("the in-process model is not the server's")
        for name in cuda_build.launches:
            cuda_build.launches[name] = 0
        mine = [lm.generate(lm.render_prompt(p), opts)
                for p in prompts[:GATE]]
        equal = [a.context == b["context"] for a, b in zip(mine, served)]
        out["gate_streams_equal"] = f"{sum(equal)}/{len(equal)}"
        out["gate_launches_in_process"] = dict(cuda_build.launches)
    finally:
        mm.shutdown()
    if not all(equal):
        raise RuntimeError(f"path 9: the HTTP server's greedy streams differ "
                           f"from preload of the same tree: {equal}")
    # path 15 (c) and (b) in this process, on the server's weights (the
    # gate's model for (c))
    t0 = time.perf_counter()
    mirostat_adapter_checks(torch, details, card, blob, cache,
                            digests[MT_MODEL], p15, base_lm=lm)
    p15_el["bc_checks"] = time.perf_counter() - t0
    del lm
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    details.setdefault("path15", {}).update(server=p15)
    details["path15"].setdefault("elapsed_s", {}).update(p15_el)
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
    details["chat_path"] = chat
    details["lifecycle_path"] = life
    return (launches, chat["launches"], life["launches"], tokenizer,
            emb["launches"])


# ---------------------------------------------------------------------------
# 8. Path 10: chat, the OpenAI routes, tools and structured output on path
# 9's server, then the grammar cross-check in this process
# ---------------------------------------------------------------------------

CHAT_PATH = "llama3.2:3b GGUF, chat and structured output: int8 paged (v3) KV"
# a llama3-style template: the chat turns and the tools when the request
# carries messages, the bare prompt otherwise (path 9's /api/generate)
CHAT_TEMPLATE = (
    "{{ if .Messages }}"
    "{{ if .Tools }}<|start_header_id|>system<|end_header_id|>\n\n"
    "You may call one of these tools. To call one, answer with a JSON "
    "object {\"name\": <the tool>, \"arguments\": {...}}.\n"
    "{{ range .Tools }}{{ json .Function }}\n{{ end }}<|eot_id|>{{ end }}"
    "{{ range .Messages }}<|start_header_id|>{{ .Role }}<|end_header_id|>"
    "\n\n{{ .Content }}{{ if .ToolCalls }}{{ range .ToolCalls }}"
    "{{ json .Function }}{{ end }}{{ end }}<|eot_id|>{{ end }}"
    "<|start_header_id|>assistant<|end_header_id|>\n\n"
    "{{ else }}{{ .Prompt }}{{ end }}")
# an object with a string, an integer, an enum and an array: inside the
# subset ops/schema.py compiles
PERSON_SCHEMA = {"type": "object", "properties": {
    "name": {"type": "string"}, "age": {"type": "integer"},
    "kind": {"enum": ["cat", "dog", "bird"]},
    "tags": {"type": "array", "items": {"type": "string"}}}}
TOOLS = [{"type": "function", "function": {
    "name": name, "description": f"the {what} in a city",
    "parameters": {"type": "object", "properties": {
        "city": {"type": "string"}}, "required": ["city"]}}}
    for name, what in (("get_weather", "weather"), ("get_time", "time"))]
# forces an invocation of one of TOOLS: the reply must parse as tool_calls
CALL_SCHEMA = {"type": "object", "properties": {
    "name": {"enum": ["get_weather", "get_time"]},
    "arguments": {"type": "object", "properties": {
        "city": {"enum": ["paris", "tokyo", "lima"]}}}}}
CHAT_COUNTERS = ("flash_prefill", "paged_decode", "qmm")
# path 10 (a)'s second turn holds the first TWINS of its 8 conversations
# to their twins (not all 8, for the run's time)
TWINS = 2


def json_prefix_ok(text: str, schema=None) -> bool:
    """Is ``text`` a prefix the port's JSON automaton (or, with
    ``schema``, its schema machine) accepts?"""
    from ollama_operator_tpu_torch.ops import constrain as C
    from ollama_operator_tpu_torch.ops import schema as S
    data = text.encode()
    if schema is None:
        return C.advance_bytes(C.INITIAL_STATE, data) is not None
    sch = S.compile_schema(schema)
    st = S.machine_init(sch.root)
    for b in data:
        st = S.machine_advance(sch.root, st, b)
        if st is None:
            return False
    return True


def person_ok(obj) -> bool:
    return (isinstance(obj, dict)
            and list(obj) == ["name", "age", "kind", "tags"]
            and isinstance(obj["name"], str)
            and isinstance(obj["age"], int)
            and obj["kind"] in ("cat", "dog", "bird")
            and all(isinstance(t, str) for t in obj["tags"]))


def chat_phase(card: str, ms, ref: str) -> dict:
    """Path 10 on path 9's model server ``ms`` (llama3.2:3b at full width
    and depth, int8 weights, int8 paged pool, the GGUF's 128256-piece
    vocabulary, the chat template layer): (a) 8 concurrent streamed chats
    on a shared system message, two turns each; (b) the OpenAI routes;
    (c) structured output (format json and a schema, response_format);
    (d) tools. Returns the record; its ``launches`` are read from the
    server's /api/ps just before and just after the phase."""
    out = {"model": GGUF_MODEL, "card": card}
    port = ms.port
    words = GGUF_WORDS
    system = " ".join(words[(7 * i) % len(words)] for i in range(420))
    before = ms.launches()
    t_phase = time.perf_counter()

    def chat(messages, stream, **kw):
        body = {"model": ref, "messages": messages, "stream": stream,
                "options": dict({"temperature": 0, "num_predict": 64},
                                **kw.pop("options", {}))}
        body.update(kw)
        return lambda: http(port, "/api/chat", body)

    def ps_prefix():
        return ms.get("/api/ps")["models"][0]["prefix_cache"]

    # (a) 8 conversations, two turns. A turn: the measured streamed round;
    # then, on the second turn (the longer cached prefix; the first's
    # twins were cut for the run's time, and the second's cover the first
    # TWINS conversations), a non-streamed twin of each
    # request, a one-token twin, and a streamed twin, which all extend the
    # same cached prefix (the whole prompt but its last token) and so run
    # the same computation: the streamed twin's text must equal the
    # non-streamed one's, and its first frame must be the first token's
    # text alone
    chat([{"role": "system", "content": system},
          {"role": "user", "content": "warm up"}], False,
         options={"num_predict": 4})()
    convs = [[{"role": "system", "content": system},
              {"role": "user", "content": " ".join(
                  words[(i + j) % len(words)] for j in range(6 + 3 * i))}]
             for i in range(8)]
    turns = []
    for turn in range(2):
        hits0 = ps_prefix()
        rounds, wall = concurrent([chat(c, True) for c in convs])
        hits1 = ps_prefix()
        twinned = turn == 1
        if twinned:
            twins, _ = concurrent([chat(c, False) for c in convs[:TWINS]])
            ones, _ = concurrent([chat(c, False,
                                       options={"num_predict": 1})
                                  for c in convs[:TWINS]])
            again, _ = concurrent([chat(c, True) for c in convs[:TWINS]])
        rec = {"ttft_ms": [], "frames": [], "eval_count": [],
               "prompt_tokens": [], "wall_s": wall}
        answers = []
        for i in range(8):
            _, frames, times = rounds[i]
            fin = frames[-1]
            n = fin["eval_count"]
            if not fin["done"] or n != 64:
                raise RuntimeError(f"chat {i} turn {turn} ended {fin}")
            twin = twinned and i < TWINS
            for fr in (frames, again[i][1]) if twin else (frames,):
                if len(fr) - 1 > -(-fr[-1]["eval_count"] // 16) + 2:
                    raise RuntimeError(f"chat {i}: {len(fr) - 1} frames "
                                       f"for {fr[-1]['eval_count']} tokens")
            answers.append("".join(f["message"]["content"]
                                   for f in frames[:-1]))
            if twin:
                text = "".join(f["message"]["content"]
                               for f in again[i][1][:-1])
                want = twins[i][1][0]["message"]["content"]
                if text != want:
                    raise RuntimeError(f"chat {i} turn {turn}: the stream's "
                                       f"text differs from the same request "
                                       f"not streamed")
                first = ones[i][1][0]["message"]["content"]
                if ("\ufffd" not in first
                        and again[i][1][0]["message"]["content"] != first):
                    raise RuntimeError(f"chat {i} turn {turn}: the first "
                                       f"frame is not the first token alone")
            rec["ttft_ms"].append(times[0] * 1e3)
            rec["frames"].append(len(frames) - 1)
            rec["eval_count"].append(n)
            rec["prompt_tokens"].append(fin["prompt_eval_count"])
        rec["tok_s"] = sum(rec["eval_count"]) / wall
        rec["reused_tokens"] = hits1["hit_tokens"] - hits0["hit_tokens"]
        rec["prefilled_tokens"] = hits1["miss_tokens"] - hits0["miss_tokens"]
        rec["stream_equals_twin"] = (f"{TWINS}/{TWINS}" if twinned
                                     else "not run")
        turns.append(rec)
        convs = [c + [{"role": "assistant", "content": answers[i]},
                      {"role": "user", "content": "and then what"}]
                 for i, c in enumerate(convs)]
        t = sorted(rec["ttft_ms"])
        print(f"path 10 (a) [{card}] turn {turn + 1}: 8 streamed chats x 64 "
              f"tokens in {wall:.3f} s: {rec['tok_s']:.1f} tok/s; TTFT ms "
              f"min {t[0]:.1f} median {t[4]:.1f} max {t[-1]:.1f}; prompt "
              f"tokens {rec['prompt_tokens']}; reused "
              f"{rec['reused_tokens']} / prefilled "
              f"{rec['prefilled_tokens']} prompt tokens; frames a response "
              f"{rec['frames']}", flush=True)
    out["chat"] = turns

    # (b) the OpenAI routes
    msgs = convs[0][:2]
    _, oai, _ = http(port, "/v1/chat/completions", {
        "model": ref, "messages": msgs, "temperature": 0, "max_tokens": 32})
    _, ol, _ = http(port, "/api/chat", {
        "model": ref, "messages": msgs, "stream": False,
        "options": {"temperature": 0, "num_predict": 32}})
    usage = oai[0]["usage"]
    if (usage["prompt_tokens"], usage["completion_tokens"],
            usage["total_tokens"]) != (
            ol[0]["prompt_eval_count"], ol[0]["eval_count"],
            ol[0]["prompt_eval_count"] + ol[0]["eval_count"]):
        raise RuntimeError(f"usage {usage} is not the Ollama counts {ol[0]}")
    _, sse, _ = http(port, "/v1/chat/completions", {
        "model": ref, "messages": msgs, "temperature": 0, "max_tokens": 32,
        "stream": True})
    if (sse[-1] != "[DONE]" or sse[0]["choices"][0]["delta"]["role"]
            != "assistant"
            or sse[-2]["choices"][0]["finish_reason"] != "length"):
        raise RuntimeError(f"SSE stream malformed: {sse[:2]} {sse[-2:]}")
    _, cmpl, _ = http(port, "/v1/completions", {
        "model": ref, "prompt": "paged attention", "max_tokens": 16,
        "temperature": 0})
    if (cmpl[0]["usage"]["completion_tokens"] != 16
            or cmpl[0]["choices"][0]["finish_reason"] != "length"):
        raise RuntimeError(f"/v1/completions answered {cmpl[0]}")
    _, models, _ = http(port, "/v1/models")
    ids = [m["id"] for m in models[0]["data"]]
    if not any(GGUF_REPO[1] in i for i in ids):
        raise RuntimeError(f"/v1/models lists {ids}")
    out["openai"] = {"usage": usage, "sse_frames": len(sse),
                     "models": ids}
    print(f"path 10 (b) [{card}]: /v1/chat/completions usage {usage} equals "
          f"/api/chat's counts; SSE {len(sse)} events ending [DONE]; "
          f"/v1/completions {cmpl[0]['usage']}; /v1/models {ids}",
          flush=True)

    # (c) structured output, greedy
    def gen(prompt, fmt, n=96):
        return lambda: http(port, "/api/generate", {
            "model": ref, "prompt": prompt, "format": fmt, "stream": False,
            "options": {"temperature": 0, "num_predict": n}})

    def tok_s(fin):
        return fin["eval_count"] / max(fin["eval_duration"] / 1e9, 1e-9)

    structured = {}
    outputs = []
    for label, call in (
            ("json first", gen("a json object about cats", "json")),
            ("json repeat", gen("a json object about cats", "json")),
            ("schema first", gen("a person as json", PERSON_SCHEMA)),
            ("schema repeat", gen("a person as json", PERSON_SCHEMA))):
        t0 = time.perf_counter()
        fin = call()[1][-1]
        structured[label] = {
            "ttft_ms": fin["prompt_eval_duration"] / 1e6,
            "total_s": time.perf_counter() - t0, "tok_s": tok_s(fin),
            "done_reason": fin["done_reason"], "eval_count":
            fin["eval_count"]}
        outputs.append((label, fin["response"], fin["done_reason"],
                        None if label.startswith("json") else PERSON_SCHEMA))
    # most greedy json outputs of these weights stop after a few tokens,
    # inside one dispatch: look for a prompt whose output runs to
    # num_predict for the json tok/s alone and beside 7 free requests
    # (two prompts, for the run's time: runs on the H100 found none among
    # sixteen)
    json_prompt = None
    for i in range(2):
        prompt = " ".join(words[(3 * i + j) % len(words)]
                          for j in range(4 + i % 9))
        fin = gen(prompt, "json")()[1][-1]
        outputs.append((f"json {prompt!r}", fin["response"],
                        fin["done_reason"], None))
        if fin["done_reason"] == "length":
            json_prompt = prompt
            structured["json to num_predict"] = {
                "prompt": prompt, "tok_s": tok_s(fin),
                "eval_count": fin["eval_count"]}
            break
    _, fr, _ = chat([{"role": "user", "content": "answer in json"}], False,
                    format="json")()
    outputs.append(("chat json", fr[0]["message"]["content"],
                    fr[0]["done_reason"], None))
    for label, rf, schema in (
            ("openai json_object", {"type": "json_object"}, None),
            ("openai json_schema", {"type": "json_schema", "json_schema": {
                "name": "person", "schema": PERSON_SCHEMA}}, PERSON_SCHEMA)):
        _, o, _ = http(port, "/v1/chat/completions", {
            "model": ref, "temperature": 0, "max_tokens": 96,
            "response_format": rf,
            "messages": [{"role": "user", "content": "a person please"}]})
        ch = o[0]["choices"][0]
        outputs.append((label, ch["message"]["content"], ch["finish_reason"],
                        schema))
    # beside 7 unconstrained requests: the constrained one streams a
    # frame a piece, so its tokens delivered while the 7 run are counted
    for label, fmt in (("json", "json"), ("schema", PERSON_SCHEMA)):
        t0 = time.perf_counter()

        def timed(call):
            def run():
                r = call()
                return r, time.perf_counter() - t0
            return run
        body = {"model": ref, "format": fmt,
                "prompt": ((json_prompt or "a json object about dogs")
                           if fmt == "json" else "a person as json"),
                "options": {
                    "temperature": 0, "num_predict": 96,
                    "stream_flush_tokens": 1, "stream_flush_ms": 0}}
        calls = [timed(lambda: http(port, "/api/generate", body))] + [
            timed(gen(" ".join(words[(i + j) % len(words)]
                               for j in range(20)), None))
            for i in range(7)]
        res, wall = concurrent(calls)
        (_, frames, times), t_end = res[0][0], res[0][1]
        fin = frames[-1]
        t_free = max(r[1] for r in res[1:])
        lag = t_end - times[-1]       # this call's start after t0
        n_beside = sum(1 for t in times[:-1] if t + lag <= t_free)
        structured[f"{label} beside 7 free"] = {
            "tokens_while_free_run": n_beside,
            "tok_s_while_free_run": n_beside / t_free,
            "free_tok_s_median": sorted(
                tok_s(r[0][1][-1]) for r in res[1:])[3],
            "free_wall_s": t_free, "tok_s_whole": tok_s(fin),
            "wall_s": wall}
        outputs.append((f"{label} beside 7",
                        "".join(f["response"] for f in frames),
                        fin["done_reason"],
                        None if fmt == "json" else PERSON_SCHEMA))
    checked = []
    for label, text, reason, schema in outputs:
        if not json_prefix_ok(text, schema):
            raise RuntimeError(f"{label}: {text!r} is not a valid prefix")
        complete = reason == "stop"
        if complete:
            obj = json.loads(text)
            if schema is not None and not person_ok(obj):
                raise RuntimeError(f"{label}: {obj} does not fit the schema")
        checked.append({"label": label, "done_reason": reason,
                        "complete": complete, "chars": len(text)})
    structured["outputs"] = checked
    out["structured"] = structured
    s = structured
    print(f"path 10 (c) [{card}]: format json first request TTFT "
          f"{s['json first']['ttft_ms']:.1f} ms, "
          f"{s['json first']['total_s']:.3f} s in all (the device table "
          f"builds between its first and second token); repeat TTFT "
          f"{s['json repeat']['ttft_ms']:.1f} ms, "
          f"{s['json repeat']['total_s']:.3f} s; schema first "
          f"{s['schema first']['total_s']:.3f} s, repeat "
          f"{s['schema repeat']['total_s']:.3f} s; tok/s alone: json "
          f"running to num_predict "
          f"{s.get('json to num_predict', {}).get('tok_s', 'not found')}, "
          f"schema {s['schema repeat']['tok_s']:.1f}; beside 7 free (while "
          f"they run): json "
          f"{s['json beside 7 free']['tok_s_while_free_run']:.2f} (free "
          f"median "
          f"{s['json beside 7 free']['free_tok_s_median']:.1f}), schema "
          f"{s['schema beside 7 free']['tok_s_while_free_run']:.2f} (free "
          f"median {s['schema beside 7 free']['free_tok_s_median']:.1f});"
          f" outputs {checked}", flush=True)

    # (d) tools
    tool_msgs = [{"role": "system", "content": system[:400]},
                 {"role": "user", "content": "what is the weather"}]
    names = [t["function"]["name"] for t in TOOLS]
    tools = {}
    for stream in (False, True):
        _, fr, _ = http(port, "/api/chat", {
            "model": ref, "messages": tool_msgs, "tools": TOOLS,
            "format": CALL_SCHEMA, "stream": stream,
            "options": {"temperature": 0, "num_predict": 64}})
        msg = fr[0]["message"]
        calls = msg.get("tool_calls") or []
        if (not calls or calls[0]["function"]["name"] not in names
                or len(fr) != (2 if stream else 1)):
            raise RuntimeError(f"/api/chat tools (stream {stream}): {fr}")
        tools[f"api_chat stream={stream}"] = calls[0]["function"]
        _, o, _ = http(port, "/v1/chat/completions", {
            "model": ref, "messages": tool_msgs, "tools": TOOLS,
            "temperature": 0, "max_tokens": 64, "stream": stream,
            "response_format": {"type": "json_schema",
                                "json_schema": {"schema": CALL_SCHEMA}}})
        if stream:
            delta = o[0]["choices"][0]["delta"]
            finish = o[1]["choices"][0]["finish_reason"]
            calls = delta.get("tool_calls") or []
        else:
            finish = o[0]["choices"][0]["finish_reason"]
            calls = o[0]["choices"][0]["message"].get("tool_calls") or []
        if (finish != "tool_calls" or not calls
                or calls[0]["function"]["name"] not in names):
            raise RuntimeError(f"/v1/chat/completions tools (stream "
                               f"{stream}): {o}")
        tools[f"openai stream={stream}"] = calls[0]["function"]
    _, fr, _ = http(port, "/api/chat", {
        "model": ref, "messages": tool_msgs, "tools": TOOLS, "stream": False,
        "options": {"temperature": 0, "num_predict": 32}})
    msg = fr[0]["message"]
    if msg["role"] != "assistant" or not isinstance(
            msg.get("tool_calls", msg.get("content")), (list, str)):
        raise RuntimeError(f"/api/chat tools without a schema: {msg}")
    tools["without a schema"] = ("tool_calls" if msg.get("tool_calls")
                                 else "content")
    out["tools"] = tools
    after = ms.launches()
    launches = {k: after[k] - before[k] for k in after}
    missing = [k for k in CHAT_COUNTERS if launches[k] <= 0]
    if missing:
        raise RuntimeError(f"path 10 launches {launches}: not launched "
                           f"{missing}")
    out["launches"] = launches
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"path 10 (d) [{card}]: tool calls {tools}; launches {launches}; "
          f"(a)-(d) took {out['phase_s']:.1f} s", flush=True)
    return out


# ---------------------------------------------------------------------------
# 9. Path 11: the lifecycle of the operator's pod, on a third start of path
# 9's model (4 slots), then the replay cross-check in this process
# ---------------------------------------------------------------------------

LIFE_PATH = "llama3.2:3b GGUF, lifecycle (4 slots): int8 paged (v3) KV"
LIFE_COUNTERS = ("flash_prefill", "paged_decode", "qmm")
LIFE_ENV = {"TPU_TENANT_MAX_QUEUED": "2", "TPU_DRAIN_TIMEOUT_S": "30"}
# the reference's 400 messages (its resolvers, runtime/admission.py and
# runtime/service.py), for the bad values path 11 sends
LIFE_BAD = (("deadline_ms", "abc", "invalid deadline_ms: 'abc'"),
            ("priority", "bogus", "invalid priority 'bogus'; expected one of "
                                  "high/normal/best_effort"),
            ("ttft_slo_ms", "soon", "invalid ttft_slo_ms: 'soon'"),
            ("disagg_prefill", True, "disagg_prefill: disaggregated prefill "
                                     "is not ported to the torch server"))
METRIC_FAMILIES = ("tpu_model_requests_total",
                   "tpu_model_generated_tokens_total",
                   "tpu_model_requests_shed_total", "tpu_model_shed_total",
                   "tpu_model_dispatch_seconds_count",
                   "tpu_model_dispatch_seconds_bucket")


def call(port: int, path: str, body=None, headers=None, timeout=600):
    """One request: (status, headers, parsed JSON or text), HTTP errors
    included."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}{path}",
        data=None if body is None else json.dumps(body).encode(),
        headers=dict(headers or {}, **{"Content-Type": "application/json"}))
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            status, hdrs, raw = r.status, r.headers, r.read()
    except urllib.error.HTTPError as e:
        status, hdrs, raw = e.code, e.headers, e.read()
    try:
        return status, hdrs, json.loads(raw)
    except ValueError:
        return status, hdrs, raw.decode()


def prometheus(text: str) -> dict:
    """``name{labels}`` → value of every sample line; raises on a line
    that is not Prometheus text."""
    out = {}
    for line in text.splitlines():
        if line and not line.startswith("#"):
            key, _, val = line.rpartition(" ")
            if not re.fullmatch(r"[a-z_:][a-z0-9_:]*(\{.*\})?", key):
                raise RuntimeError(f"not Prometheus text: {line!r}")
            out[key] = float(val)
    return out


class Stream:
    """A streamed /api/generate on a thread: ``first_s`` (time to the
    first frame), ``frames``; ``close_after_first`` drops the connection
    after the first frame (the server then cancels the request)."""

    def __init__(self, port, ref, prompt, options, tenant,
                 close_after_first=False):
        self.first_s = None
        self.frames, self.error = [], None
        self.got_first = threading.Event()
        body = {"model": ref, "prompt": prompt, "options": options}
        self.req = urllib.request.Request(
            f"http://127.0.0.1:{port}/api/generate",
            data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json",
                     "X-Tenant": tenant})
        self.close_after_first = close_after_first
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.t0 = time.perf_counter()
        self.thread.start()

    def _run(self):
        try:
            with urllib.request.urlopen(self.req, timeout=600) as r:
                for line in r:
                    if not line.strip():
                        continue
                    self.frames.append(json.loads(line))
                    if self.first_s is None:
                        self.first_s = time.perf_counter() - self.t0
                        self.got_first.set()
                        if self.close_after_first:
                            return
        except Exception as e:  # noqa: BLE001 — read by the caller
            self.error = repr(e)
        finally:
            self.got_first.set()

    def join(self, timeout=600):
        self.thread.join(timeout)
        if self.thread.is_alive() or self.error:
            raise RuntimeError(f"stream failed: {self.error}")
        return self.frames


def lifecycle_phase(card: str, ms, ref: str) -> dict:
    """Path 11 on a third start of path 9's model (``ms``: 4 slots,
    TPU_TENANT_MAX_QUEUED=2, TPU_DRAIN_TIMEOUT_S=30): (a) the probes,
    /metrics and the /api/ps blocks; (b) a deadline that ends a stream
    with "timeout", and one that sheds a queued request with 503; (c) four
    high requests behind eight best_effort ones; (d) the tenant cap's 429
    and the TTFT SLO's 503; (e) request traces; (f) the reference's 400s;
    (g) SIGTERM while four streams run. Returns the record; its
    ``launches`` are read from /api/ps at the start and just before the
    SIGTERM."""
    out = {"model": GGUF_MODEL, "card": card, "env": LIFE_ENV}
    port = ms.port
    words = GGUF_WORDS
    t_phase = time.perf_counter()

    def prompt(i, n=12):
        return " ".join(words[(5 * i + j) % len(words)] for j in range(n))

    def gen(options, i=0, headers=None, stream=False):
        return call(port, "/api/generate", {
            "model": ref, "prompt": prompt(i), "stream": stream,
            "options": dict({"temperature": 0}, **options)}, headers)

    # (a) the probes and /metrics after preload
    for path in ("/healthz", "/livez", "/readyz"):
        status, _, text = call(port, path)
        if (status, text) != (200, "ok"):
            raise RuntimeError(f"(a) {path} answered {status} {text!r}")
    m = prometheus(call(port, "/metrics")[2])
    before = ms.launches()

    # (b) a deadline mid-generation: "timeout" with partial output
    status, _, r = gen({"deadline_ms": 300, "num_predict": 512})
    if status != 200 or r["done_reason"] != "timeout" or not (
            0 < r["eval_count"] < 512):
        raise RuntimeError(f"(b) deadline_ms 300: {status} {r}")
    out["deadline_timeout"] = {"eval_count": r["eval_count"],
                               "total_ms": r["total_duration"] / 1e6}
    # four streams fill the slots; a queued request's deadline passes
    fill = [Stream(port, ref, prompt(10 + i), {"temperature": 0,
                                               "num_predict": 96},
                   f"fill{i}") for i in range(4)]
    for f in fill:
        f.got_first.wait(120)
    t0 = time.perf_counter()
    status, hdrs, r = gen({"deadline_ms": 200, "num_predict": 8}, 20,
                          {"X-Tenant": "late"})
    out["queued_deadline"] = {"status": status, "s": time.perf_counter() - t0,
                              "retry_after": hdrs.get("Retry-After")}
    if status != 503 or not hdrs.get("Retry-After"):
        raise RuntimeError(f"(b) queued deadline: {status} {r}")
    # (d) tenant a's third queued request: 429; a 1 ms TTFT SLO behind
    # that backlog: 503
    queued_a = [Stream(port, ref, prompt(30 + i), {"temperature": 0,
                                                   "num_predict": 8}, "a")
                for i in range(2)]
    time.sleep(0.5)
    status, hdrs, r = gen({"num_predict": 8}, 32, {"X-Tenant": "a"})
    out["tenant_cap"] = {"status": status, "retry_after":
                         hdrs.get("Retry-After"), "error": r.get("error")}
    if status != 429 or not hdrs.get("Retry-After"):
        raise RuntimeError(f"(d) tenant cap: {status} {r}")
    status, hdrs, r = gen({"num_predict": 8, "ttft_slo_ms": 1}, 33,
                          {"X-Tenant": "slo"})
    out["ttft_slo"] = {"status": status, "retry_after":
                       hdrs.get("Retry-After"), "error": r.get("error")}
    if status != 503 or not hdrs.get("Retry-After"):
        raise RuntimeError(f"(d) ttft_slo_ms 1: {status} {r}")
    for s in fill + queued_a:
        frames = s.join()
        if frames[-1].get("done_reason") not in ("length", "stop"):
            raise RuntimeError(f"(b)/(d) stream ended {frames[-1]}")

    # (c) four high requests behind eight best_effort ones: each
    # best_effort stream is dropped after its first frame (128 tokens a
    # request)
    opts = {"temperature": 0, "num_predict": 128}
    low = [Stream(port, ref, prompt(40 + i),
                  dict(opts, priority="best_effort"), f"be{i}",
                  close_after_first=True) for i in range(8)]
    time.sleep(1.5)
    high = [Stream(port, ref, prompt(50 + i), dict(opts, priority="high"),
                   f"hi{i}") for i in range(4)]
    for s in high:
        frames = s.join()
        if frames[-1].get("done_reason") not in ("length", "stop"):
            raise RuntimeError(f"(c) high stream ended {frames[-1]}")
    for s in low:
        s.join()
    ttft = {}
    for cls, group in (("high", high), ("best_effort", low)):
        t = sorted(s.first_s for s in group)
        ttft[cls] = {"median_s": t[len(t) // 2], "max_s": t[-1], "all": t}
    out["ttft_by_class"] = ttft
    print(f"path 11 (c) [{card}]: TTFT s, 4 high behind 8 best_effort "
          f"(4 slots, 128 tokens each): high median "
          f"{ttft['high']['median_s']:.3f} max {ttft['high']['max_s']:.3f}; "
          f"best_effort median {ttft['best_effort']['median_s']:.3f} max "
          f"{ttft['best_effort']['max_s']:.3f}", flush=True)
    if not ttft["high"]["median_s"] < ttft["best_effort"]["median_s"]:
        raise RuntimeError(f"(c) high TTFT not below best_effort: {ttft}")

    # (e) traces
    status, _, r = gen({"num_predict": 8, "trace": True}, 60)
    tm = r.get("timings") if status == 200 else None
    if not tm or not tm.get("spans"):
        raise RuntimeError(f"(e) no timings: {status} {r}")
    _, _, tr = call(port, f"/debug/trace?id={tm['request_id']}")
    evs = [e["ev"] for e in tr.get("events", [])]
    if "dispatch" not in evs or "finish" not in evs:
        raise RuntimeError(f"(e) /debug/trace: {tr}")
    _, _, ring = call(port, "/debug/events")
    kinds = collections.Counter(e["kind"] for e in ring["events"])
    if not kinds.get("admit") or not kinds.get("shed"):
        raise RuntimeError(f"(e) /debug/events: {kinds}")
    out["trace"] = {"spans": [s["ev"] for s in tm["spans"]],
                    "events": len(evs), "flight_kinds": dict(kinds)}

    # (f) the reference's 400s
    for key, value, want in LIFE_BAD:
        status, _, r = gen({key: value, "num_predict": 4}, 61)
        if (status, r.get("error")) != (400, want):
            raise RuntimeError(f"(f) {key}={value!r}: {status} {r}")

    # (a) the /api/ps blocks and /metrics after the traffic
    ps = ms.get("/api/ps")["models"][0]
    util, life = ps["utilization"], ps["lifecycle"]
    mfu = util.get("mfu")
    m2 = prometheus(call(port, "/metrics")[2])
    missing = [f for f in METRIC_FAMILIES
               if not any(k.split("{")[0] == f for k in m2)]
    out["ps"] = {"admission": ps["admission"], "lifecycle": life,
                 "utilization": util}
    out["metrics"] = {k: m2[k] for k in m2 if k.startswith((
        "tpu_model_requests_total", "tpu_model_generated_tokens_total",
        "tpu_model_requests_shed_total", "tpu_model_shed_total",
        "tpu_model_request_timeouts_total"))}
    if (life["state"] != "serving" or "queued_by_class" not in ps["admission"]
            or not util.get("peak_flops") or mfu is None
            or not 0 < mfu < 1 or missing
            or m2["tpu_model_requests_total"] <= m.get(
                "tpu_model_requests_total", 0)):
        raise RuntimeError(f"(a) /api/ps {out['ps']}, metrics missing "
                           f"{missing}")
    print(f"path 11 (a) [{card}]: probes 200; /metrics "
          f"{len(m2)} samples; /api/ps lifecycle {life['state']}, watchdog "
          f"budget {life['watchdog']['timeout_s']} s; utilization on "
          f"{util['device_kind']} peak {util['peak_flops']:.4g} FLOP/s: MFU "
          f"{mfu} over {util['window_s']} s, goodput "
          f"{util['goodput_tok_s']} tok/s, occupancy {util['occupancy']}, "
          f"breakdown {util['breakdown']}", flush=True)

    # (g) SIGTERM while four streams run
    runs = [Stream(port, ref, prompt(70 + i), {"temperature": 0,
                                               "num_predict": 64},
                   f"g{i}") for i in range(4)]
    for s in runs:
        s.got_first.wait(120)
    after = ms.launches()
    out["launches"] = {k: after[k] - before[k] for k in after}
    t_term = time.perf_counter()
    ms.proc.send_signal(15)
    time.sleep(0.3)
    ready = call(port, "/readyz")
    live = call(port, "/livez")
    shed = gen({"num_predict": 4}, 80, {"X-Tenant": "new"})
    ends = [s.join()[-1] for s in runs]
    code = ms.proc.wait(timeout=60)
    exit_s = time.perf_counter() - t_term
    log = ms.tail(20000)
    drain_s = re.findall(r"drain: ([0-9.]+) s", log)
    out["sigterm"] = {"readyz": ready[::2], "livez": live[::2],
                      "new_request": [shed[0], shed[1].get("Retry-After")],
                      "done_reasons": [e.get("done_reason") for e in ends],
                      "exit_code": code, "exit_s": exit_s,
                      "drain_s": float(drain_s[-1]) if drain_s else None}
    print(f"path 11 (g) [{card}]: SIGTERM with 4 streams running: readyz "
          f"{ready[::2]}, livez {live[::2]}, a new request {shed[0]} "
          f"(Retry-After {shed[1].get('Retry-After')}); streams ended "
          f"{out['sigterm']['done_reasons']}; drain "
          f"{out['sigterm']['drain_s']} s; exit {code} after "
          f"{exit_s:.2f} s", flush=True)
    if (ready[::2] != (503, "draining") or live[::2] != (200, "ok")
            or shed[0] != 503 or not shed[1].get("Retry-After")
            or any(e.get("done_reason") not in ("length", "drain")
                   or not e.get("done") for e in ends)
            or code != 0 or exit_s > 30 + 10):
        raise RuntimeError(f"(g) SIGTERM: {out['sigterm']}")
    missing = [k for k in LIFE_COUNTERS if out["launches"][k] <= 0]
    stray = [k for k in GGUF_ABSENT if out["launches"][k] != 0]
    if missing or stray:
        raise RuntimeError(f"path 11 launches {out['launches']}: not "
                           f"launched {missing}, of another path {stray}")
    out["phase_s"] = time.perf_counter() - t_phase
    print(f"path 11 [{card}]: (b) deadline 300 ms ended with timeout after "
          f"{out['deadline_timeout']['eval_count']} tokens, a queued 200 ms "
          f"deadline shed 503 after {out['queued_deadline']['s']:.2f} s "
          f"(Retry-After {out['queued_deadline']['retry_after']}); (d) "
          f"tenant cap 429 (Retry-After {out['tenant_cap']['retry_after']}),"
          f" ttft_slo_ms 1 503 (Retry-After "
          f"{out['ttft_slo']['retry_after']}); (e) spans "
          f"{out['trace']['spans']}; (f) 400s as the reference; launches "
          f"{out['launches']}; {out['phase_s']:.1f} s", flush=True)
    return out


def replay_cross_check(torch, details, card: str, tokenizer) -> dict:
    """(h) In this process: llama3.2:3b at full width and two layers, int8
    weights, the paged int8 pool, TPU_DISPATCH_WATCHDOG_MS=500. Four greedy
    and two seeded streams (200-token prompts, 128 tokens) run unfailed,
    then again with one dispatch wait wedged 2 s by the engine.watchdog
    fault point mid-stream: the watchdog fires, the scheduler restarts
    and replays them through K1. Every stream must end without an error
    frame; a greedy stream's tokens must equal the unfailed run's up to a
    step whose top-2 logit gap (a prefill of the unfailed tokens) is a
    near-tie (below 3% of max |logit| twice over), and the tokens after
    it are counted as not decidable; the seeded streams' equal tokens are
    reported."""
    import gc

    from ollama_operator_tpu_torch.models import decoder
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.runtime.engine import SlotOptions
    from ollama_operator_tpu_torch.runtime.faults import FAULTS
    from ollama_operator_tpu_torch.runtime.service import LoadedModel
    from ollama_operator_tpu_torch.runtime.trace import FLIGHT
    from ollama_operator_tpu_torch.server.app import apply_engine_dtype
    cfg = dataclasses.replace(get_config(GGUF_MODEL), n_layers=2)
    params = apply_engine_dtype(dense_params(torch, cfg), "int8", "cuda")
    out = {"model": GGUF_MODEL, "layers": 2, "card": card}
    g = torch.Generator(device="cpu").manual_seed(SEED + 11)
    prompts = [torch.randint(0, cfg.vocab_size, (200 + 7 * i,),
                             generator=g).tolist() for i in range(6)]
    greedy = SlotOptions(temperature=0.0, repeat_penalty=1.0)
    seeded = [SlotOptions(temperature=0.8, seed=SEED + i, repeat_penalty=1.0)
              for i in range(2)]
    opts = [greedy] * 4 + seeded
    n_tok = 128

    def run(fault: bool):
        lm = LoadedModel(GGUF_MODEL, cfg, params, tokenizer,
                         template=CHAT_TEMPLATE, device="cuda",
                         kv_dtype="int8", paged=True)
        sched = lm.scheduler
        sched.restart_backoff = 0.0
        got = [[] for _ in prompts]
        errors = []
        try:
            reqs = [sched.submit(p, o, n_tok) for p, o in zip(prompts, opts)]

            def read(i):
                try:
                    for c in reqs[i].chunks():
                        got[i].extend(c)
                except Exception as e:  # noqa: BLE001 — checked below
                    errors.append(f"stream {i}: {e!r}")

            threads = [threading.Thread(target=read, args=(i,))
                       for i in range(len(reqs))]
            for t in threads:
                t.start()
            seq0 = FLIGHT.seq
            if fault:
                # mid-stream: after every stream has a decode dispatch
                t0 = time.perf_counter()
                while (min(len(x) for x in got) < 2
                       and time.perf_counter() - t0 < 120):
                    time.sleep(0.001)
                FAULTS.arm("engine.watchdog", "delay:2s:once")
            for t in threads:
                t.join(timeout=600)
            evs = [e for e in FLIGHT.snapshot() if e["seq"] > seq0]
            stats = {"watchdog_fires": sched.n_watchdog_fires,
                     "restarts": sched.n_restarts,
                     "replays": sched.n_replays,
                     "fallbacks": sched.n_replay_fallbacks,
                     "done": [r.done_reason for r in reqs]}
            return got, errors, stats, evs, lm
        finally:
            FAULTS.disarm("engine.watchdog")

    # whole admissions: every stream is decoding when the fault lands
    with mock.patch.dict(os.environ, {"TPU_DISPATCH_WATCHDOG_MS": "500",
                                      "TPU_PREFILL_CHUNK": "0"}):
        ref, ref_err, ref_stats, _, lm = run(False)
        lm.unload()
        got, err, stats, evs, lm = run(True)
        lm.unload()
    if ref_err or ref_stats["watchdog_fires"] or ref_stats["restarts"]:
        raise RuntimeError(f"(h) the unfailed run failed: {ref_err} "
                           f"{ref_stats}")
    t_of = {}
    for e in evs:
        t_of.setdefault(e["kind"], e["t_unix"])
    readmit = [e for e in evs if e["kind"] == "replay_readmit"]
    replayed = {e["rid"] for e in evs if e["kind"] == "replay"}
    t_admits = [e["t_unix"] for e in evs if e["kind"] == "admit"
                and e["rid"] in replayed
                and readmit and e["t_unix"] >= readmit[0]["t_unix"]]
    out["restart_s"] = (t_of["restart"] - t_of["watchdog"]
                        if "restart" in t_of and "watchdog" in t_of else None)
    out["replay_s"] = ((max(t_admits) - t_of["restart"])
                       if t_admits and "restart" in t_of else None)
    out["stats"] = stats
    rows = []
    n_undecided = 0
    for i, (a, b) in enumerate(zip(ref, got)):
        k = next((j for j in range(min(len(a), len(b))) if a[j] != b[j]),
                 None)
        row = {"stream": i, "kind": "greedy" if i < 4 else "seeded",
               "tokens": len(b), "equal": sum(x == y for x, y in zip(a, b)),
               "first_divergence": k}
        if k is not None and i < 4:
            # the unfailed tokens' logits at the divergence
            seq = prompts[i] + a[:k]
            ids = torch.zeros((1, -(-len(seq) // 64) * 64),
                              dtype=torch.long, device="cuda")
            ids[0, :len(seq)] = torch.tensor(seq, device="cuda")
            x = decoder.prefill_hidden(params, cfg, ids)[0]
            lg = decoder._unembed(cfg, params,
                                  x[:, len(seq) - 1]).float()[0]
            top2 = lg.topk(2).values
            gap = float(top2[0] - top2[1])
            tol = 3e-2 * max(1.0, float(lg.abs().max()))
            row.update(gap=gap, tol=tol, decidable=gap > 2 * tol)
            n_undecided += len(b) - k
        rows.append(row)
    out["streams"] = rows
    out["greedy_tokens_not_decidable"] = n_undecided
    print(f"path 11 (h) [{card}]: watchdog 500 ms, one dispatch wait "
          f"wedged 2 s: fires {stats['watchdog_fires']}, restarts "
          f"{stats['restarts']}, replays {stats['replays']}, fallbacks "
          f"{stats['fallbacks']}; watchdog to restart "
          f"{out['restart_s']} s, restart to the replays admitted "
          f"{out['replay_s']} s; streams equal to the unfailed run "
          f"{[r['equal'] for r in rows]} of {[r['tokens'] for r in rows]}; "
          f"greedy tokens after a near-tie divergence (not decidable): "
          f"{n_undecided}", flush=True)
    bad = [r for r in rows if r["kind"] == "greedy"
           and r["first_divergence"] is not None and r["decidable"]]
    if (err or stats["watchdog_fires"] != 1 or stats["replays"] != 6
            or stats["fallbacks"] or any(len(x) != n_tok for x in got)
            or bad):
        raise RuntimeError(f"(h) replay: errors {err}, {stats}, decidable "
                           f"divergences {bad}")
    details["replay_cross_check"] = out
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def escape_walk(gt, table, tokens) -> int:
    """The escapes a device-table run of ``tokens`` (a request's stream
    after its first token's state is known) would make: steps from a
    tabled state to one outside the table by a legal, non-EOG token."""
    from ollama_operator_tpu_torch.ops.constrain import (INITIAL_STATE,
                                                         advance_bytes)
    st, n = INITIAL_STATE, 0
    for i, t in enumerate(tokens):
        nxt = advance_bytes(st, table.pieces[t]) if table.pieces[t] else None
        if nxt is None:
            break
        if i > 0 and gt.state_id(st) >= 0 and gt.state_id(nxt) < 0:
            n += 1
        st = nxt
    return n


def grammar_cross_check(torch, details, card: str, tokenizer) -> dict:
    """(e) In this process: llama3.2:3b at full width and two layers with
    int8 weights and the GGUF's tokenizer, on the paged int8 pool and on
    the dense bf16 cache. Greedy ``format: "json"`` streams with the
    device table at 64 states and at 4 states must equal the streams with
    host masks (``TPU_GRAMMAR_DEVICE=0``), and the 4-state table must be
    left at least once. Also times the table builds on this host."""
    import gc

    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops.constrain import (GrammarTable,
                                                         TokenTable)
    from ollama_operator_tpu_torch.runtime.service import LoadedModel
    from ollama_operator_tpu_torch.server.app import apply_engine_dtype
    cfg = dataclasses.replace(get_config(GGUF_MODEL), n_layers=2)
    params = apply_engine_dtype(dense_params(torch, cfg), "int8", "cuda")
    out = {"model": GGUF_MODEL, "layers": 2, "card": card}
    t0 = time.perf_counter()
    table = TokenTable.for_tokenizer(tokenizer)
    out["token_table_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    g64 = GrammarTable.for_table(table, cap=64)
    out["grammar_table_64_s"] = time.perf_counter() - t0
    out["grammar_table_64_states"] = g64.n_states
    t0 = time.perf_counter()
    g4 = GrammarTable.for_table(table, cap=4)
    out["grammar_table_4_s"] = time.perf_counter() - t0
    words = GGUF_WORDS

    def prompts(lo, hi):
        return [" ".join(words[(3 * i + j) % len(words)]
                         for j in range(4 + i % 9)) for i in range(lo, hi)]

    def run(cache, knob, ps):
        env = {"TPU_GRAMMAR_DEVICE": "0" if knob == "host" else "1",
               "TPU_GRAMMAR_STATES": "4" if knob == "device-4" else "64"}
        with mock.patch.dict(os.environ, env):
            lm = LoadedModel(GGUF_MODEL, cfg, params, tokenizer,
                             template=CHAT_TEMPLATE, device="cuda",
                             kv_dtype=cache[0], paged=cache[1])
        try:
            res = [_final(lm.generate_stream(
                p, {"temperature": 0, "num_predict": 64}, format="json"))
                for p in ps]
            return res, lm.scheduler.n_grammar_escapes
        finally:
            lm.unload()
            del lm
            gc.collect()
            torch.cuda.empty_cache()

    for cache in (("int8", True), ("bfloat16", False)):
        name = f"{cache[0]} {'paged' if cache[1] else 'dense'}"
        ps = prompts(0, 8)
        host, _ = run(cache, "host", ps)
        # more prompts until a 4-state walk would leave its table
        while (sum(escape_walk(g4, table, r.context[r.prompt_tokens:])
                   for r in host) == 0 and len(ps) < 32):
            extra = prompts(len(ps), len(ps) + 8)
            ps += extra
            host += run(cache, "host", extra)[0]
        rec = {"prompts": len(ps)}
        for knob in ("device-64", "device-4"):
            got, escapes = run(cache, knob, ps)
            equal = sum(a.context == b.context for a, b in zip(host, got))
            rec[knob] = {"streams_equal": f"{equal}/{len(ps)}",
                         "escapes": escapes}
            if equal != len(ps):
                raise RuntimeError(f"(e) {name}: {knob} streams differ from "
                                   f"host masks ({equal}/{len(ps)})")
        if rec["device-4"]["escapes"] <= 0:
            raise RuntimeError(f"(e) {name}: no escape from the 4-state "
                               f"table")
        for r in host:
            if not json_prefix_ok(tokenizer.decode(
                    r.context[r.prompt_tokens:])):
                raise RuntimeError(f"(e) {name}: output is not JSON")
        rec["done_reasons"] = dict(collections.Counter(
            r.done_reason for r in host))
        out[name] = rec
        print(f"path 10 (e) [{card}] {name}: greedy json streams with the "
              f"device table at 64 and 4 states equal host masks: "
              f"{rec['device-64']['streams_equal']} / "
              f"{rec['device-4']['streams_equal']}; escapes "
              f"{rec['device-64']['escapes']} / {rec['device-4']['escapes']}"
              f"; done {rec['done_reasons']}", flush=True)
    print(f"path 10 (e) [{card}]: token table {out['token_table_s']:.2f} s, "
          f"grammar table {g64.n_states} states "
          f"{out['grammar_table_64_s']:.2f} s, 4 states "
          f"{out['grammar_table_4_s']:.2f} s (this host, Python mask fill)",
          flush=True)
    details["grammar_cross_check"] = out
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


# -- path 12: gemma3 at full width and depth -----------------------------

GEMMA3_PATH = "gemma3 int8 paged (gather + einsum) KV, 12 layers"
# path 12's depth: 12 of gemma3's 34 layers (two full-attention layers,
# 5 and 11, among ten sliding ones), cut for the run's time; the replay
# check holds at any depth
# the gemma turn format, as the gemma3 image's template renders it: the
# chat turns for /api/chat, one user turn around the bare prompt for
# /api/generate
GEMMA_TEMPLATE = (
    "{{ if .Messages }}{{ range .Messages }}<start_of_turn>"
    "{{ if eq .Role \"assistant\" }}model{{ else }}{{ .Role }}{{ end }}\n"
    "{{ .Content }}<end_of_turn>\n{{ end }}<start_of_turn>model\n"
    "{{ else }}<start_of_turn>user\n{{ .Prompt }}<end_of_turn>\n"
    "<start_of_turn>model\n{{ end }}")
# gemma3's path: the int8 projections and the tied head, no attention
# kernel (its layers alternate windows: prefill, extends and paged decode
# attend through the einsum, as in the JAX package)
GEMMA3_COUNTERS = ("qmm",)
GEMMA3_ABSENT = ("flash_prefill", "qmm4") + PAGED_COUNTERS + DENSE_COUNTERS
GEMMA3_LONG = 1500      # the long prompt's tokens
GEMMA3_LAYERS = 12


def gemma3_phase(torch, details) -> dict:
    """Path 12: gemma3 at ``GEMMA3_LAYERS`` of its 34 layers (dim 2560,
    8/4 heads, hd 256, tied vocab 262208) with random bf16 weights from
    the seed, through ``ModelManager.preload`` at the server's defaults
    (int8 weights, the dtype its full depth resolves to, K7;
    an int8 paged pool of 64 slots, 128-row pages, 768 pages), behind the
    HTTP server with the gemma template: 8 concurrent greedy requests of
    32 tokens, four on /api/generate (one a 1500-token prompt, which goes
    through six 256-token pieces and past the sliding layers' 1024
    window) and four two-turn /api/chat conversations. Launches: qmm above
    0, every attention kernel 0. Then, with the scheduler stopped, the
    decode step (``step_breakdown``), and the long request's served
    tokens held against the engine's calls for it replayed teacher-forced
    on the card (``teacher_forced``). Returns the requests' launch
    counts."""
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import cuda_build
    from ollama_operator_tpu_torch.server.app import ModelManager, serve
    from ollama_operator_tpu_torch.runtime.engine import resolve_engine_dtype
    full = get_config("gemma3")
    cfg = dataclasses.replace(full, n_layers=GEMMA3_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dense_params(torch, cfg)
    mm = ModelManager()
    lm = mm.preload("gemma3", cfg, params, byte_tokenizer(cfg.vocab_size),
                    dtype=resolve_engine_dtype(full, "cuda"),
                    template=GEMMA_TEMPLATE, kv_dtype="int8")
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t_build = time.perf_counter() - t0
    e = lm.ecfg
    if lm.serving_dtype != "int8" or not lm.engine.paged:
        raise RuntimeError(f"gemma3 serves {lm.serving_dtype}, paged "
                           f"{lm.engine.paged}")
    print(f"serving {GEMMA3_PATH}: slots={e.max_slots} "
          f"page_size={e.page_size} pages={e.n_pages} "
          f"max_seq={e.max_seq_len} chunk={e.decode_chunk} "
          f"kv_bytes={lm.engine.kv_bytes / 1e9:.2f}GB build_s={t_build:.1f}",
          flush=True)
    httpd = serve(mm, "127.0.0.1", 0)
    port = httpd.server_address[1]
    words = ("gemma three alternates five sliding layers with one global "
             "layer and serves them all on one card").split()
    # GEMMA3_LONG tokens (the byte tokenizer spells a space as three
    # bytes of "▁")
    long_prompt = " ".join(words[i % len(words)] for i in range(400))
    while (n := len(lm.tokenizer.encode(long_prompt))) > GEMMA3_LONG:
        long_prompt = long_prompt[:-max(1, (n - GEMMA3_LONG) // 3)]
    # greedy over the raw logits (no repeat penalty), so that the
    # teacher-forced forward's argmax is the served token
    opts = {"temperature": 0, "num_predict": 32, "repeat_penalty": 1.0}
    gen_prompts = [long_prompt] + [
        " ".join(words[(3 * i + j) % len(words)] for j in range(10 + 5 * i))
        for i in range(1, 4)]
    chats = [[{"role": "system", "content": "answer briefly"},
              {"role": "user", "content": " ".join(words[i:i + 6])},
              {"role": "assistant", "content": " ".join(words[i + 2:i + 5])},
              {"role": "user", "content": f"and then {words[i + 7]}?"}]
             for i in range(4)]
    out = None
    try:
        http(port, "/api/chat", {"model": "gemma3", "stream": False,
                                 "options": opts, "messages": [
                                     {"role": "user", "content": "hi"}]})
        for name in cuda_build.launches:
            cuda_build.launches[name] = 0
        t0 = time.perf_counter()
        # raw prompts (no template; an empty context, so that the final
        # frame carries the tokens): no two of them, nor a chat, share 16
        # tokens, so none stitches a prefix another one donated and each
        # is admitted from position 0, as the cross-check replays it
        calls = ([lambda p=p: http(port, "/api/generate", {
            "model": "gemma3", "prompt": p, "raw": True, "context": [],
            "options": opts})
            for p in gen_prompts]
            + [lambda m=m: http(port, "/api/chat", {
                "model": "gemma3", "messages": m, "options": opts})
               for m in chats])
        results, wall = concurrent(calls)
        launches = dict(cuda_build.launches)
        finals = [frames[-1] for _, frames, _ in results]
        for i, f in enumerate(finals):
            if not f.get("done") or f.get("eval_count") != 32:
                raise RuntimeError(f"path 12 request {i} ended {f}")
        missing = [k for k in GEMMA3_COUNTERS if launches[k] <= 0]
        stray = [k for k in GEMMA3_ABSENT if launches[k] != 0]
        if missing or stray:
            raise RuntimeError(f"path 12 launches: missing {missing}, "
                               f"stray {stray} ({launches})")
        long_n = finals[0]["prompt_eval_count"]
        if long_n <= cfg.sliding_window + 256:
            raise RuntimeError(f"the long prompt took {long_n} tokens")
        n_tok = sum(f["eval_count"] for f in finals)
        ttft = sorted(f["prompt_eval_duration"] / 1e6 for f in finals)
        chat_text = ["".join(fr.get("message", {}).get("content", "")
                             for fr in frames)
                     for _, frames, _ in results[4:]]
        out = {"model": "gemma3", "layers": cfg.n_layers,
               "weights": lm.serving_dtype, "kv": "int8", "paged": True,
               "requests": len(finals), "wall_s": wall,
               "generated_tokens": n_tok, "aggregate_tok_s": n_tok / wall,
               "ttft_ms": ttft, "kv_bytes": lm.engine.kv_bytes,
               "prompt_tokens": [f["prompt_eval_count"] for f in finals],
               "chat_chars": [len(t) for t in chat_text],
               "launches": launches}
        print(f"serving {GEMMA3_PATH}: {len(finals)} requests (4 "
              f"/api/generate, one of {long_n} prompt tokens; 4 /api/chat) "
              f"x 32 tokens in {wall:.3f} s: {n_tok / wall:.1f} tok/s "
              f"aggregate; TTFT ms median {ttft[len(ttft) // 2]:.1f} max "
              f"{ttft[-1]:.1f}; launches {launches}", flush=True)
    except BaseException:
        close_serving(torch, details, out=None, mm=mm, httpd=httpd, lm=lm)
        raise
    httpd.shutdown()
    httpd.server_close()
    mm.shutdown()
    out["step"] = step_breakdown(torch, lm.engine)
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(f"path 12 peak memory {out['peak_memory_bytes'] / 1e9:.2f} GB; "
          f"kernels a step {out['step']['kernel_launches_per_step']}",
          flush=True)
    # the long request's served tokens against the engine's calls for it
    # replayed teacher-forced on the kernel path: the same tokens at every
    # step (the plain path is held at 6 layers in FAMILY_CHECKS)
    ids = finals[0]["context"][:long_n]
    served = finals[0]["context"][long_n:]
    _, replayed = teacher_forced(
        torch, cfg, lm.engine.params, ids, len(served) - 1, "int8",
        teacher=served, engine=lm.engine, piece=lm.scheduler.prefill_chunk)
    equal = sum(a == b for a, b in zip(served, replayed))
    out["replay"] = {"prompt_tokens": long_n, "served_tokens": served,
                     "replayed_tokens": replayed, "equal": equal}
    print(f"path 12 replay ({long_n}-token prompt in "
          f"{lm.scheduler.prefill_chunk}-token pieces, {len(served)} served "
          f"tokens, teacher-forced on the kernel path): equal at "
          f"{equal}/{len(served)} steps", flush=True)
    if replayed != served:
        raise RuntimeError(f"path 12: served tokens {served} differ from "
                           f"the replayed kernel path's {replayed}")
    details["gemma3"] = out
    del lm
    import gc
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# gemma3's two-layer cut keeps one layer of each kind: layer 0 sliding
# (window 1024, the local rope), layer 1 full attention with the global
# rope (theta 1e6, linear factor 8), as its layers 5, 11, ... are
GEMMA3_CUT = {"n_layers": 2, "sliding_pattern": 2}
# the two-layer, full-width cross-checks of the other families: (preset
# or ``MOE_CONFIGS`` name, config cut, weight bits (16: dense bf16), KV
# pool, paged, prompt tokens, environment, the kernels the kernel path
# must launch). The mixture-of-experts ones first: qwen3moe on the bf16
# dense cache (K1 at 32/4 heads, K2 at G 8), qwen2moe with its shared
# expert and attention biases through K3 (MHA 16/16), mixtral with int4
# attention projections (K8) beside its dense bf16 experts
MOE_FAMILIES = ("qwen3moe", "qwen2moe", "mixtral")
FAMILY_CHECKS = (
    ("qwen3moe", None, 16, "bfloat16", False, 200, {},
     ("flash_prefill", "decode_attention")),
    ("qwen2moe", None, 16, "bfloat16", False, 200, {"TPU_MHA_KERNEL": "1"},
     ("flash_prefill", "mha_decode")),
    ("mixtral", None, 4, "bfloat16", False, 200, {},
     ("flash_prefill", "decode_attention", "qmm4")),
    ("gemma3", GEMMA3_CUT, 8, "int8", True, 1500, {}, ("qmm",)),
    ("qwen3", None, 4, "int8", True, 200, {},
     ("flash_prefill", "paged_decode", "qmm4")),
    ("gemma2", None, 4, "int8", True, 4200, {}, ("qmm4",)),
    ("starcoder2", None, 8, "int8", True, 200, {},
     ("flash_prefill", "paged_decode", "qmm")),
    ("starcoder2", None, 8, "int8", True, 200, {"TPU_PAGED_V3": "0"},
     ("flash_prefill", "paged_decode_v2", "qmm")),
    ("starcoder2", None, 8, "int8", True, 200, {"TPU_PAGED_V4": "1"},
     ("flash_prefill", "paged_decode_v4", "qmm")),
    ("starcoder2", None, 8, "bfloat16", False, 200, {},
     ("flash_prefill", "decode_attention", "qmm")),
    ("phi", None, 8, "int8", True, 200, {},
     ("flash_prefill", "paged_decode", "qmm")),
    ("gemma", None, 4, "int8", True, 200, {},
     ("flash_prefill", "paged_decode", "qmm4")))


def family_cross_checks(torch, details, families=None):
    """``FAMILY_CHECKS``, or those of the names in ``families``."""
    for model, cut, bits, kv, paged, n, env, expect in FAMILY_CHECKS:
        if families is not None and model not in families:
            continue
        with mock.patch.dict(os.environ, env):
            cross_check(torch, details, model, bits, kv, paged=paged,
                        n_prompt=n, expect=expect, cut=cut)


def moe_layer_times(torch, timer, details):
    """One qwen3moe layer's ``_moe_mlp`` (128 experts of 768, top-8, bf16
    weights from the seed) at N = 8 tokens (a decode step of 8 slots) and
    N = 256 (a chunked piece), in the "einsum" form the serving path takes
    there, and at 256 in the "scan" form: the device time (the kernel
    timer: L2 flushed first) against the least time for the work, the
    larger of the bytes it must move (every expert's weights: the einsum
    reads all 128; the scan the experts the tokens chose) over 3.35 TB/s
    and its bf16 operations over 989 TFLOP/s. Not a TPU kernel: the JAX
    package computes it outside any Pallas kernel."""
    from ollama_operator_tpu_torch.models import decoder
    cfg = model_config("qwen3moe")
    E, D, Fd = cfg.n_experts, cfg.dim, cfg.ffn_dim
    g = torch.Generator(device="cuda").manual_seed(SEED)

    def w(*shape):
        return (torch.randn(shape, generator=g, device="cuda")
                * 0.02).to(torch.bfloat16)
    lp = {"router": w(D, E), "we_gate": w(E, D, Fd), "we_up": w(E, D, Fd),
          "we_down": w(E, Fd, D)}
    expert_bytes = 3 * D * Fd * 2
    rows = []
    for n, form in ((8, "einsum"), (256, "einsum"), (256, "scan")):
        c = dataclasses.replace(cfg, moe_impl=form)
        x = w(1, n, D) * 50.0
        topi = decoder._moe_route(c, lp, x[0])[1]
        used = E if form == "einsum" else int(topi.unique().numel())
        mult = E if form == "einsum" else n * cfg.n_experts_used
        flops = 2 * n * D * E + 3 * 2 * mult * D * Fd
        nbytes = used * expert_bytes + D * E * 2 + 2 * 2 * n * D
        ms = timer(lambda: decoder._moe_mlp(c, lp, x))
        b_ms, b_by = bound(nbytes, flops)
        rows.append({"tokens": n, "form": form, "experts_read": used,
                     "ms": ms, "bound_ms": b_ms, "bound_by": b_by})
        print(f"qwen3moe MoE layer (_moe_mlp, {form}) at N={n}: {ms:.4f} ms; "
              f"bound {b_ms:.4f} ms ({b_by}: {used} experts' "
              f"{used * expert_bytes / 1e9:.3f} GB); x48 layers "
              f"{48 * ms:.2f} ms", flush=True)
    details["moe_layer"] = rows
    del lp
    torch.cuda.empty_cache()


def dense_replay(torch, engine, ids, teacher, piece: int):
    """The calls a dense-cache ``engine`` made for a request admitted from
    position 0, replayed teacher-forced on the card: the prompt ``ids`` in
    ``piece``-token pieces (a prefill and an insert, then extends over the
    slot's first ``bucket_for(start + bucket)`` rows, each padded to the
    engine's bucket), the first token from the last prompt row's hidden
    state alone, then one step a token of ``teacher`` (fed the served
    token, the previous argmax's place) in a batch of the engine's slot
    count (row 0; the others idle at length 0) over the first
    ``bucket_for(len(ids) + chunk + steps)`` rows, the width the engine's
    dispatch attends for the request as the longest slot. Each matmul
    takes the row count, and so the form, the served one took. Returns
    the argmax tokens, the first token's and one a step."""
    from ollama_operator_tpu_torch.models import decoder
    cfg, params, dev = engine.cfg, engine.params, engine.device
    n, steps, rows = len(ids), len(teacher) - 1, engine.n_slots
    bucket_for = engine.bucket_for
    A = min(bucket_for(n + engine.ecfg.decode_chunk + steps), engine.max_seq)
    shp = (cfg.n_layers, rows, cfg.n_kv_heads, A, cfg.head_dim)
    if isinstance(engine.kv.k, dict):
        kc, vc = ({"q": torch.zeros(shp, dtype=torch.int8, device=dev),
                   "s": torch.zeros(shp[:-1], device=dev)} for _ in "kv")
    else:
        kc, vc = (torch.zeros(shp, dtype=engine.kv.k.dtype, device=dev)
                  for _ in "kv")

    def padded(toks):
        out = torch.zeros((1, bucket_for(len(toks))), dtype=torch.long,
                          device=dev)
        out[0, :len(toks)] = torch.tensor(toks, device=dev)
        return out

    def slot_rows(c, width):
        if isinstance(c, dict):
            return {k: t[:, :1, :, :width] for k, t in c.items()}
        return c[:, :1, :, :width]
    first = min(piece, n)
    x, ks, vs = decoder.prefill_hidden(params, cfg, padded(ids[:first]))
    decoder.dense_insert(kc, vc, ks, vs, 0)
    last = x[:, first - 1]
    for start in range(first, n, piece):
        tail = ids[start:start + piece]
        toks = padded(tail)
        width = bucket_for(start + toks.shape[1])
        x, _, _ = decoder.forward_with_cache(
            params, cfg, toks, slot_rows(kc, width), slot_rows(vc, width),
            torch.tensor([start], dtype=torch.int32, device=dev),
            hidden=True)
        last = x[:, len(tail) - 1]
    out = [int(decoder._unembed(cfg, params, last)[0].argmax())]
    lengths = torch.zeros(rows, dtype=torch.int32, device=dev)
    toks = torch.zeros((rows, 1), dtype=torch.long, device=dev)
    for step in range(steps):
        lengths[0] = n + step
        toks[0, 0] = int(teacher[step])
        lg, _, _ = decoder.forward_with_cache(params, cfg, toks, kc, vc,
                                              lengths, attn_len=A)
        out.append(int(lg[0, 0].argmax()))
    return out


MOE_PATH = "qwen3moe bf16, dense int8 KV (8 slots), full depth"
# path 13's kernels: K1 at every prefill and piece; the int8 dense cache
# decodes through attend_hf_q (no kernel, as in the JAX package) and the
# bf16 weights take no dequant matmul
MOE_COUNTERS = ("flash_prefill",)
MOE_ABSENT = ("qmm", "qmm4") + PAGED_COUNTERS + DENSE_COUNTERS
MOE_PROMPTS = (96, 127, 158, 190, 221, 253, 284, 316)   # prompt tokens


def moe_phase(torch, details) -> dict:
    """Path 13: qwen3moe (qwen3:30b-a3b) at full width and depth — 48
    layers, dim 2048, 32/4 heads, hd 128, qk-norm, 128 experts of 768,
    top-8 renormalised, untied vocab 151936 — with random bf16 weights
    from the seed (61.06 GB) through ``ModelManager.preload``, which
    serves them in bf16 on the dense int8 slot cache (8 slots) at
    max_seq_len 4096, behind the HTTP server: 8 concurrent greedy
    /api/generate requests of 96-316 prompt tokens (two past 256: two
    chunked pieces) and 32 tokens, then a repeat over a parked prefix.
    K1's count above 0, every other kernel's 0. Then the decode step
    (``step_breakdown``), and the longest and the shortest request's
    served tokens against the engine's calls for them replayed
    teacher-forced on the card (``dense_replay``). Returns the requests'
    launch counts."""
    import gc

    from ollama_operator_tpu_torch.ops import cuda_build
    from ollama_operator_tpu_torch.server.app import ModelManager, serve
    cfg = model_config("qwen3moe")
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = dense_params(torch, cfg)
    weight_bytes = sum(v.numel() * v.element_size() for v in (
        *params["layers"].values(),
        *(v for k, v in params.items() if k != "layers")))
    mm = ModelManager()
    lm = mm.preload("qwen3moe", cfg, params, byte_tokenizer(cfg.vocab_size),
                    template="{{ .Prompt }}")
    del params
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    e = lm.ecfg
    if (lm.serving_dtype != "bfloat16" or lm.engine.paged
            or e.cache_dtype is not torch.int8 or e.max_slots != 8):
        raise RuntimeError(f"qwen3moe serves {lm.serving_dtype} weights, "
                           f"paged {lm.engine.paged}, {e.cache_dtype} KV, "
                           f"{e.max_slots} slots")
    print(f"serving {MOE_PATH}: {cfg.n_params / 1e9:.2f}e9 parameters, "
          f"weights {weight_bytes / 1e9:.2f} GB; slots={e.max_slots} "
          f"max_seq={e.max_seq_len} chunk={e.decode_chunk} "
          f"kv_bytes={lm.engine.kv_bytes / 1e9:.2f}GB; memory allocated "
          f"before {before / 1e9:.2f} GB, after the build "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB; "
          f"build_s={t_build:.1f}", flush=True)
    httpd = serve(mm, "127.0.0.1", 0)
    port = httpd.server_address[1]
    words = ("experts route every token to eight of one hundred twenty "
             "eight feed forward blocks on one card").split()
    leads = ("alpha", "bravo", "charlie", "delta", "echo", "foxtrot",
             "golf", "hotel")
    prompts = []
    for i, want in enumerate(MOE_PROMPTS):
        # distinct first words: no two prompts (nor the warm-up) share a
        # parked prefix, so each is admitted from position 0
        p = leads[i] + " " + " ".join(words[(3 * i + j) % len(words)]
                                      for j in range(120))
        while (n := len(lm.tokenizer.encode(p))) > want:
            p = p[:-max(1, (n - want) // 3)]
        prompts.append(p)
    # greedy over the raw logits (no repeat penalty), so that the
    # replay's argmax is the served token
    opts = {"temperature": 0, "num_predict": 32, "repeat_penalty": 1.0}
    out = None
    try:
        post(port, {"model": "qwen3moe", "prompt": "warm up", "raw": True,
                    "stream": False, "options": opts})
        for name in cuda_build.launches:
            cuda_build.launches[name] = 0
        results, wall = concurrent([
            lambda p=p: post(port, {"model": "qwen3moe", "prompt": p,
                                    "raw": True, "context": [],
                                    "options": opts}) for p in prompts])
        launches = dict(cuda_build.launches)
        for i, r in enumerate(results):
            if not r.get("done") or r.get("eval_count") != 32:
                raise RuntimeError(f"path 13 request {i} ended {r}")
        missing = [k for k in MOE_COUNTERS if launches[k] <= 0]
        stray = [k for k in MOE_ABSENT if launches[k] != 0]
        if missing or stray:
            raise RuntimeError(f"path 13 launches: missing {missing}, "
                               f"stray {stray} ({launches})")
        rep = lm.generate(prompts[3], opts)
        if rep.reused_tokens <= 0:
            raise RuntimeError("path 13's repeat reused no parked prefix")
        n_tok = sum(r["eval_count"] for r in results)
        ttft = sorted(r["prompt_eval_duration"] / 1e6 for r in results)
        out = {"model": "qwen3moe", "layers": cfg.n_layers,
               "n_params": cfg.n_params, "weight_bytes": weight_bytes,
               "weights": lm.serving_dtype, "kv": "int8", "paged": False,
               "requests": len(results), "wall_s": wall,
               "generated_tokens": n_tok, "aggregate_tok_s": n_tok / wall,
               "ttft_ms": ttft, "kv_bytes": lm.engine.kv_bytes,
               "prompt_tokens": [r["prompt_eval_count"] for r in results],
               "repeat_reused_tokens": rep.reused_tokens,
               "memory_before_bytes": before, "build_s": t_build,
               "launches": launches}
        print(f"serving {MOE_PATH}: {len(results)} requests (prompt tokens "
              f"{out['prompt_tokens']}) x 32 tokens in {wall:.3f} s: "
              f"{n_tok / wall:.1f} tok/s aggregate; TTFT ms median "
              f"{ttft[len(ttft) // 2]:.1f} max {ttft[-1]:.1f}; launches "
              f"{launches}; the repeat reused {rep.reused_tokens} tokens",
              flush=True)
    except BaseException:
        close_serving(torch, details, out=None, mm=mm, httpd=httpd, lm=lm)
        raise
    httpd.shutdown()
    httpd.server_close()
    mm.shutdown()
    t_served = time.perf_counter()
    out["served_s"] = t_served - t0
    out["step"] = step_breakdown(torch, lm.engine)
    out["step_s"] = time.perf_counter() - t_served
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    print(f"path 13 memory: {before / 1e9:.2f} GB allocated before, peak "
          f"{out['peak_memory_bytes'] / 1e9:.2f} GB; kernels a step "
          f"{out['step']['kernel_launches_per_step']}", flush=True)
    # the longest (two pieces) and the shortest request's served tokens
    # against the engine's calls for them replayed teacher-forced
    out["replay"] = []
    for i in (len(results) - 1, 0):
        n = results[i]["prompt_eval_count"]
        ids, served = results[i]["context"][:n], results[i]["context"][n:]
        replayed = dense_replay(torch, lm.engine, ids, served,
                                lm.scheduler.prefill_chunk)
        equal = sum(a == b for a, b in zip(served, replayed))
        out["replay"].append({"prompt_tokens": n, "served_tokens": served,
                              "replayed_tokens": replayed, "equal": equal})
        print(f"path 13 replay ({n}-token prompt in "
              f"{lm.scheduler.prefill_chunk}-token pieces, {len(served)} "
              f"served tokens, teacher-forced on the card): equal at "
              f"{equal}/{len(served)} steps", flush=True)
        if replayed != served:
            raise RuntimeError(f"path 13: served tokens {served} differ "
                               f"from the replayed engine calls' "
                               f"{replayed}")
    out["replay_s"] = time.perf_counter() - t_served - out["step_s"]
    # path 14 (d) on the same model
    t0 = time.perf_counter()
    ep = details.setdefault("embed_path", {})
    ep["d"] = moe_embed(torch, lm)
    ep.setdefault("elapsed_s", {})["d"] = time.perf_counter() - t0
    print(f"path 13 times: build and serve {out['served_s']:.1f} s, decode "
          f"step {out['step_s']:.1f} s (its profiled dispatch "
          f"{out['step']['profiled_dispatch_s']:.1f} s), replays "
          f"{out['replay_s']:.1f} s", flush=True)
    details["qwen3moe"] = out
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# 12. Path 14: embeddings — decoder embeddings on path 9's server (a),
# two-layer kernel-against-plain embedding cross-checks (b), a BERT
# encoder (mxbai-embed-large) uploaded, created, copied and served (c),
# and one embed on path 13's qwen3moe (d)
# ---------------------------------------------------------------------------

EMBED_PATH = "llama3.2:3b GGUF, embeddings: int8 weights, K1 + K7 over " \
             "padded buckets"
EMBED_MOE_PATH = "qwen3moe bf16 embeddings (path 14 (d))"
EMBED_COUNTERS = ("flash_prefill", "qmm")
EMBED_TEXTS = 64
# mixedbread-ai/mxbai-embed-large-v1 (BERT-large): 24 layers, dim 1024, 16
# heads, ffn 4096, 512 positions, 2 token types, vocab 30522, CLS pooling
MXBAI = dict(n_layers=24, dim=1024, n_heads=16, ffn_dim=4096,
             max_seq_len=512, n_token_types=2, vocab_size=30522)
MXBAI_NAME = "mxbai-embed-large:latest"


def bucket_of(n: int) -> int:
    """The decoder embed's length bucket of an n-token text."""
    return max(16, 1 << (max(n, 1) - 1).bit_length())


def cosine_rows(a, b):
    """Per-row cosine similarity and max |a - b| / max |b| of two [N, D]
    arrays."""
    import numpy as np
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    cos = (a * b).sum(1) / np.maximum(
        np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1), 1e-30)
    rel = np.abs(a - b).max(1) / np.maximum(np.abs(b).max(1), 1e-30)
    return cos, rel


def embed_phase(card: str, ms, ref: str, tokenizer) -> dict:
    """Path 14 (a) on path 9's server (llama3.2:3b, int8 weights, the
    paged engine): /api/embed of ``EMBED_TEXTS`` texts whose token lengths
    are drawn from the seed over 20..500 (length buckets 32..512 of up to
    64 rows); K1 and K7 must launch (their /api/ps counts rise). Then,
    beside 8 running generate streams, one text through /api/embed,
    /api/embeddings and /v1/embeddings: the three vectors equal, and
    equal within tolerance (cosine >= 0.999, max |delta| <= 3% of max
    |x|) to its row in the batch, which ran in another bucket size."""
    import numpy as np

    from ollama_operator_tpu_torch.models.config import get_config
    rng = np.random.default_rng(SEED + 14)
    want = rng.integers(20, 501, EMBED_TEXTS)
    # n - 1 words of the vocabulary's whole-word pieces, and the BOS
    texts = [" ".join(GGUF_WORDS[(i + j) % len(GGUF_WORDS)]
                      for j in range(n - 1)) for i, n in enumerate(want)]
    lens = [len(tokenizer.encode(t)) for t in texts]
    buckets = collections.Counter(bucket_of(n) for n in lens)
    shapes = {T: 1 << (c - 1).bit_length() for T, c in buckets.items()}
    before = ms.launches()
    t0 = time.perf_counter()
    status, _, body = call(ms.port, "/api/embed",
                           {"model": ref, "input": texts})
    wall = time.perf_counter() - t0
    after = ms.launches()
    launches = {k: after[k] - before[k] for k in after}
    if status != 200:
        raise RuntimeError(f"path 14 (a): /api/embed answered {status}: "
                           f"{body}")
    vecs = np.asarray(body["embeddings"], np.float32)
    dim = get_config(GGUF_MODEL).dim
    if vecs.shape != (EMBED_TEXTS, dim) or not np.isfinite(vecs).all():
        raise RuntimeError(f"path 14 (a): embeddings of shape {vecs.shape}, "
                           f"finite {np.isfinite(vecs).all()}")
    missing = [k for k in EMBED_COUNTERS if launches[k] <= 0]
    stray = [k for k in GGUF_ABSENT if launches[k] != 0]
    if missing or stray:
        raise RuntimeError(f"path 14 (a) launches {launches}: not launched "
                           f"{missing}, of another path {stray}")
    # one text, three routes, beside 8 running generate streams
    k = int(np.argmax([n if bucket_of(n) == 256 else 0 for n in lens]))
    gen = [lambda i=i: post(ms.port, {
        "model": ref, "prompt": " ".join(GGUF_WORDS[i:] + GGUF_WORDS[:i]),
        "options": {"temperature": 0, "num_predict": 64}})
        for i in range(8)]
    routes = [
        lambda: call(ms.port, "/api/embed", {"model": ref,
                                             "input": [texts[k]]}),
        lambda: call(ms.port, "/api/embeddings", {"model": ref,
                                                  "prompt": texts[k]}),
        lambda: call(ms.port, "/v1/embeddings", {"model": ref,
                                                 "input": texts[k]})]
    results, busy_wall = concurrent(
        gen + [lambda: (time.sleep(1.0), [r() for r in routes])[1]])
    for i, r in enumerate(results[:8]):
        if not r.get("done") or r.get("eval_count") != 64:
            raise RuntimeError(f"path 14 (a): generate {i} ended {r}")
    got = results[8]
    if any(s != 200 for s, _, _ in got):
        raise RuntimeError(f"path 14 (a): routes answered "
                           f"{[(s, b) for s, _, b in got]}")
    three = np.asarray([got[0][2]["embeddings"][0], got[1][2]["embedding"],
                        got[2][2]["data"][0]["embedding"]], np.float32)
    spread = float(np.abs(three - three[0]).max())
    cos, rel = cosine_rows(three[:1], vecs[k:k + 1])
    out = {"texts": EMBED_TEXTS, "token_lengths": lens,
           "tokens": int(sum(lens)), "buckets": {str(T): [c, shapes[T]]
                                                 for T, c in
                                                 sorted(buckets.items())},
           "wall_s": wall, "texts_per_s": EMBED_TEXTS / wall,
           "tokens_per_s": sum(lens) / wall, "launches": launches,
           "alone_text": k, "alone_tokens": lens[k],
           "routes_max_abs_spread": spread,
           "alone_vs_batch_cosine": float(cos[0]),
           "alone_vs_batch_rel": float(rel[0]),
           "beside_8_streams_wall_s": busy_wall}
    print(f"path 14 (a) [{card}]: /api/embed of {EMBED_TEXTS} texts "
          f"({sum(lens)} tokens; bucket: (texts, rows) "
          f"{out['buckets']}) in {wall:.3f} s: {out['texts_per_s']:.1f} "
          f"texts/s, {out['tokens_per_s']:.0f} tokens/s; launches "
          f"{launches}; one {lens[k]}-token text through the three routes "
          f"beside 8 generate streams: spread {spread:.3g}, against its "
          f"batch row cosine {cos[0]:.6f}, max |delta| {rel[0]:.3%} of max "
          f"|x|", flush=True)
    if spread > 1e-5 * float(np.abs(three).max()):
        raise RuntimeError(f"path 14 (a): the three routes differ "
                           f"({spread})")
    if not (cos[0] >= 0.999 and rel[0] <= 0.03):
        raise RuntimeError(f"path 14 (a): the text alone differs from its "
                           f"batch row (cosine {cos[0]}, {rel[0]:.3%})")
    return out


def embed_cross_check(torch, details, model: str, bits: int,
                      n_texts: int = 32, T: int = 512) -> dict:
    """Path 14 (b): two layers at full width, ``bits``-bit weights:
    ``decoder.embed_forward`` over one [n_texts, T] batch (valid lengths
    drawn from the seed over T/2+1..T) on the kernel path (K1, and K8 or
    K7 at N = n_texts * T rows) and on the plain path (their plain
    versions), each row's pooled vector at cosine >= 0.999 and max
    |delta| <= 3% of its max |x|. Returns the kernel path's launches."""
    from ollama_operator_tpu_torch.models import decoder
    from ollama_operator_tpu_torch.ops import attention as A
    from ollama_operator_tpu_torch.ops import cuda_build
    from ollama_operator_tpu_torch.ops import quant as Q
    cfg = dataclasses.replace(model_config(model), n_layers=2)
    params = Q.quantize_params(dense_params(torch, cfg), bits=bits)
    g = torch.Generator(device="cuda").manual_seed(SEED + bits)
    toks = torch.randint(0, cfg.vocab_size, (n_texts, T), generator=g,
                         device="cuda")
    lens = torch.randint(T // 2 + 1, T + 1, (n_texts,), generator=g,
                         device="cuda")

    def plain_chunk(cfg, q, k, v, scale):
        return A.flash_prefill_plain(q, k, v, scale, cfg.attn_softcap,
                                     cfg.sliding_window)

    for name in cuda_build.launches:
        cuda_build.launches[name] = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        got = decoder.embed_forward(params, cfg, toks, lens)
        torch.cuda.synchronize()
        t_kernel = time.perf_counter() - t0
        launched = {k: v for k, v in cuda_build.launches.items() if v}
        with mock.patch.object(decoder, "chunk_attention", plain_chunk), \
                mock.patch.object(Q, "matmul", plain_matmul):
            want = decoder.embed_forward(params, cfg, toks, lens)
    cos, rel = cosine_rows(got.cpu().numpy(), want.cpu().numpy())
    kname = "qmm4" if bits == 4 else "qmm"
    out = {"model": model, "layers": 2, "weights": f"int{bits}",
           "rows": n_texts, "T": T, "N": n_texts * T, "launches": launched,
           "min_cosine": float(cos.min()), "max_rel": float(rel.max()),
           "kernel_path_s": t_kernel}
    details.setdefault("embed_path", {}).setdefault("cross_checks",
                                                    []).append(out)
    print(f"path 14 (b) {model} int{bits} (2 layers, full width, "
          f"[{n_texts}, {T}] batch, N = {n_texts * T}): launches "
          f"{launched}; kernel vs plain pooled rows: min cosine "
          f"{cos.min():.6f}, max |delta| {rel.max():.3%} of max |x|",
          flush=True)
    if launched.get("flash_prefill", 0) <= 0 or launched.get(kname, 0) <= 0:
        raise RuntimeError(f"path 14 (b) {model}: kernels not launched "
                           f"({launched})")
    if not (cos.min() >= 0.999 and rel.max() <= 0.03):
        raise RuntimeError(f"path 14 (b) {model}: kernel and plain pooled "
                           f"vectors disagree ({cos.min()}, {rel.max()})")
    del params, got, want
    torch.cuda.empty_cache()
    return launched


def embed_kernel_rows(torch, timer, report, k1_rows: int, k8_rows: int,
                      T: int = 512):
    """Kernel rows at the embedding shapes: K1 at path 14 (a)'s largest
    bucket (``k1_rows`` texts x T, llama3.2:3b's 24/8 heads), K7 at its
    w_gate (N = k1_rows * T), K8 at (b)'s llama3.1 w_gate (N = k8_rows *
    T); each against its plain version (K1 every query row within 1% of
    its largest output, K7/K8 max |err| <= 1e-3 over f32 outputs), beside
    its bound and its library call (SDPA, the bf16 matmul on the
    dequantized weight). Returns the new rows."""
    import torch.nn.functional as F
    from ollama_operator_tpu_torch.ops import attention as A
    from ollama_operator_tpu_torch.ops import quant as Q
    g = torch.Generator(device="cuda").manual_seed(SEED + 140)
    bf = torch.bfloat16
    start = len(report.rows)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale
                ).to(bf)

    B, H, KvH, hd = k1_rows, 24, 8, 128
    q, k, v = randn(B, T, H, hd), randn(B, KvH, T, hd), randn(B, KvH, T, hd)
    scale = hd ** -0.5
    out = A.flash_prefill(q, k, v, scale)
    ref = A.flash_prefill_plain(q, k, v, scale)
    d = (out.float() - ref.float()).reshape(B * T, -1).abs().amax(1)
    tol = 1e-2 * ref.float().reshape(B * T, -1).abs().amax(1)
    w = int((d / tol.clamp(min=1e-30)).argmax())
    check = (d[w].item(), tol[w].item(), d.max().item(), f"query {w}",
             (out != ref).float().mean().item())
    qh = q.transpose(1, 2)
    kr = k.repeat_interleave(H // KvH, dim=1)
    vr = v.repeat_interleave(H // KvH, dim=1)
    report("flash_prefill", "csrc/flash_prefill.cu",
           "ollama_operator_tpu/ops/pallas/flash.py:134", check,
           timer(lambda: A.flash_prefill(q, k, v, scale)),
           timer(lambda: A.flash_prefill_plain(q, k, v, scale), iters=3),
           timer(lambda: F.scaled_dot_product_attention(
               qh, kr, vr, is_causal=True, scale=scale)),
           *bound(2 * (2 * q.numel() + k.numel() + v.numel()),
                  4 * B * H * hd * T * (T + 1) / 2),
           shape=f"embed B={B} T={T} H={H} KvH={KvH} hd={hd}", main=False)
    del q, k, v, qh, kr, vr, out, ref
    for name, fn, plain, quant, replaces, N, K, O in (
            ("qmm", Q.qmm, Q.qmm_plain, Q.quantize_groupwise,
             "ollama_operator_tpu/ops/pallas/quant.py:73", k1_rows * T,
             3072, 8192),
            ("qmm4", Q.qmm4, Q.qmm4_plain, Q.quantize_groupwise_int4,
             "ollama_operator_tpu/ops/pallas/quant.py:142", k8_rows * T,
             4096, 14336)):
        qw = quant(torch.randn((K, O), generator=g, device="cuda") * 0.02)
        codes = qw["q4"] if "q4" in qw else qw["q"]
        wbf = Q.dequantize_groupwise(qw).to(bf)
        x = randn(N, K)
        err = (fn(x, codes, qw["s"]) - plain(x, codes, qw["s"])
               ).abs().max().item()
        report(name, f"csrc/{name}.cu", replaces, (err, 1e-3),
               timer(lambda: fn(x, codes, qw["s"])),
               timer(lambda: plain(x, codes, qw["s"]), iters=3),
               timer(lambda: torch.matmul(x, wbf)),
               *bound(2 * N * K + codes.numel() + 4 * (K // 32) * O
                      + 4 * N * O, 2.0 * N * K * O),
               shape=f"embed w_gate N={N} K={K} O={O}", main=False)
        del qw, codes, wbf, x
    torch.cuda.empty_cache()
    rows = report.rows[start:]
    bad = [r for r in rows if not r["ok"]]
    if bad:
        raise RuntimeError(f"path 14 kernel rows disagree with their "
                           f"plain versions: {bad}")
    return rows


def bert_vocab(rng, n: int):
    """A WordPiece vocabulary of ``n`` pieces made from the seed: BERT's
    [PAD], [unused*], [UNK], [CLS], [SEP], [MASK] at their ids, the words
    of the path's texts, then random lowercase words and ## pieces."""
    import numpy as np
    pieces = ["[PAD]"] + [f"[unused{i}]" for i in range(99)] + [
        "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    pieces += sorted(set(GGUF_WORDS))
    seen = set(pieces)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    while len(pieces) < n:
        w = "".join(rng.choice(letters, int(rng.integers(2, 9))))
        if rng.random() < 0.3:
            w = "##" + w
        if w not in seen:
            seen.add(w)
            pieces.append(w)
    return pieces


def write_bert_model(torch, path: str) -> dict:
    """mxbai-embed-large's shape as a llama.cpp BERT GGUF from the seed:
    f16 matrices and tables (std 0.02, drawn on the card),
    f32 norms (around 1) and biases (std 0.02), CLS pooling, a
    30522-piece WordPiece vocabulary. Written one tensor at a time."""
    import numpy as np

    from ollama_operator_tpu_torch.gguf.writer import GGUFWriter
    c = MXBAI
    rng = np.random.default_rng(SEED + 15)
    g = torch.Generator(device="cuda").manual_seed(SEED + 15)
    vocab = bert_vocab(rng, c["vocab_size"])
    w = GGUFWriter(path)
    for k, v in (("general.architecture", "bert"),
                 ("general.name", "mxbai-embed-large-v1 (random weights)"),
                 ("general.file_type", 1),
                 ("bert.block_count", c["n_layers"]),
                 ("bert.context_length", c["max_seq_len"]),
                 ("bert.embedding_length", c["dim"]),
                 ("bert.feed_forward_length", c["ffn_dim"]),
                 ("bert.attention.head_count", c["n_heads"]),
                 ("bert.attention.layer_norm_epsilon", 1e-12),
                 ("bert.pooling_type", 2),
                 ("tokenizer.ggml.model", "bert"),
                 ("tokenizer.ggml.tokens", vocab),
                 ("tokenizer.ggml.token_type", [1] * len(vocab)),
                 ("tokenizer.ggml.cls_token_id", 101),
                 ("tokenizer.ggml.seperator_token_id", 102),
                 ("tokenizer.ggml.unknown_token_id", 100),
                 ("tokenizer.ggml.padding_token_id", 0)):
        w.add_meta(k, v)
    D, Fd = c["dim"], c["ffn_dim"]

    def mat(name, *shape):
        w.add_tensor_f16(name, (torch.randn(shape, generator=g,
                                            device="cuda") * 0.02)
                         .half().cpu().numpy())

    def vec(name, n, base=0.0, std=0.02):
        w.add_tensor_f32(name, (base + rng.standard_normal(n, np.float32)
                                * std).astype(np.float32))

    mat("token_embd.weight", c["vocab_size"], D)
    mat("position_embd.weight", c["max_seq_len"], D)
    mat("token_types.weight", c["n_token_types"], D)
    vec("token_embd_norm.weight", D, 1.0, 0.05)
    vec("token_embd_norm.bias", D)
    for i in range(c["n_layers"]):
        for name in ("attn_q", "attn_k", "attn_v", "attn_output"):
            mat(f"blk.{i}.{name}.weight", D, D)
            vec(f"blk.{i}.{name}.bias", D)
        mat(f"blk.{i}.ffn_up.weight", Fd, D)
        vec(f"blk.{i}.ffn_up.bias", Fd)
        mat(f"blk.{i}.ffn_down.weight", D, Fd)
        vec(f"blk.{i}.ffn_down.bias", D)
        for name in ("attn_output_norm", "layer_output_norm"):
            vec(f"blk.{i}.{name}.weight", D, 1.0, 0.05)
            vec(f"blk.{i}.{name}.bias", D)
    w.write()
    del w
    return {"path": path, "bytes": os.path.getsize(path), "vocab": vocab}


def upload_blob(port: int, path: str, digest: str) -> int:
    """POST the file to /api/blobs/<digest>, streamed; the status."""
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
    try:
        with open(path, "rb") as f:
            conn.request("POST", f"/api/blobs/{digest}", body=f, headers={
                "Content-Length": str(os.path.getsize(path))})
        r = conn.getresponse()
        r.read()
        return r.status
    finally:
        conn.close()


def encoder_phase(torch, card: str, ms, workdir: str) -> dict:
    """Path 14 (c) on a model server with a store: mxbai-embed-large at
    full width and depth (``MXBAI``), written as a GGUF from the seed,
    POSTed to /api/blobs, created by ``files``, copied, shown under both
    names, loaded (f32, no engine), /api/embed of 64 texts of up to 600
    words (cut at 512 tokens, as the reference cuts them); /api/generate
    on it answers 400. The card's vectors of 4 texts against the port's
    f32 forward of the same GGUF on the CPU in this process (cosine >=
    0.9999), and the peak bytes on the card of one 64-text forward in
    this process."""
    import numpy as np

    from ollama_operator_tpu_torch.convert import params_from_numpy
    from ollama_operator_tpu_torch.gguf.reader import GGUFFile
    from ollama_operator_tpu_torch.gguf.transcode import (
        encoder_config_from_gguf, load_encoder_params)
    from ollama_operator_tpu_torch.models import encoder as E
    from ollama_operator_tpu_torch.tokenizer import Tokenizer
    out = {"model": MXBAI_NAME, "card": card}
    t0 = time.perf_counter()
    g = write_bert_model(torch, os.path.join(workdir, "mxbai.gguf"))
    out["gguf_bytes"] = g["bytes"]
    out["write_gguf_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    digest = sha256_file(g["path"])
    head = urllib.request.Request(
        f"http://127.0.0.1:{ms.port}/api/blobs/{digest}", method="HEAD")

    def head_status():
        try:
            with urllib.request.urlopen(head, timeout=60) as r:
                return r.status
        except urllib.error.HTTPError as e:
            return e.code

    before = head_status()
    status = upload_blob(ms.port, g["path"], digest)
    after = head_status()
    out["upload_s"] = time.perf_counter() - t0
    if (before, status, after) != (404, 201, 200):
        raise RuntimeError(f"path 14 (c): blob HEAD/POST/HEAD answered "
                           f"{(before, status, after)}")
    copy = MXBAI_NAME.replace(":latest", ":copy")
    steps = [
        ("/api/create", {"model": MXBAI_NAME, "stream": False,
                         "files": {"mxbai.gguf": digest}}),
        ("/api/copy", {"source": MXBAI_NAME, "destination": copy})]
    for path, body in steps:
        s, _, b = call(ms.port, path, body)
        if s != 200:
            raise RuntimeError(f"path 14 (c): {path} answered {s}: {b}")
    shown = [call(ms.port, "/api/show", {"model": n}) for n in
             (MXBAI_NAME, copy)]
    if any(s != 200 or b["details"]["family"] != "bert"
           for s, _, b in shown) or shown[0][2]["model_info"] != shown[1][
                2]["model_info"]:
        raise RuntimeError(f"path 14 (c): /api/show of the model and its "
                           f"copy: {[(s, b.get('details')) for s, _, b in shown]}")
    t0 = time.perf_counter()
    s, _, b = call(ms.port, "/api/generate", {"model": copy, "prompt": ""})
    out["load_s"] = time.perf_counter() - t0
    if s != 200 or b.get("done_reason") != "load":
        raise RuntimeError(f"path 14 (c): the load answered {s}: {b}")
    s, _, b = call(ms.port, "/api/generate", {"model": copy,
                                              "prompt": "hi"})
    if s != 400 or "embedding model" not in str(b):
        raise RuntimeError(f"path 14 (c): generation answered {s}: {b}")
    ps = ms.get("/api/ps")["models"][0]
    if (ps["details"]["family"], ps["details"]["serving_dtype"]) != (
            "bert", "float32"):
        raise RuntimeError(f"path 14 (c): /api/ps {ps['details']}")
    words = [p for p in g["vocab"][104:] if not p.startswith("##")]
    rng = np.random.default_rng(SEED + 16)
    n_words = [int(x) for x in rng.integers(4, 40, 4)] + [
        int(x) for x in rng.integers(20, 601, EMBED_TEXTS - 4)]
    texts = [" ".join(rng.choice(words, n)) for n in n_words]
    with GGUFFile(g["path"]) as f:
        ecfg = encoder_config_from_gguf(f)
        tree = load_encoder_params(f, ecfg)
        tok = Tokenizer.from_gguf_metadata(
            {k: v for k, v in f.metadata.items()
             if k.startswith("tokenizer.")})
    lens = [min(len(tok.encode(t)), ecfg.max_seq_len) for t in texts]
    t0 = time.perf_counter()
    s, _, b = call(ms.port, "/api/embed", {"model": copy, "input": texts})
    wall = time.perf_counter() - t0
    if s != 200:
        raise RuntimeError(f"path 14 (c): /api/embed answered {s}: {b}")
    vecs = np.asarray(b["embeddings"], np.float32)
    if vecs.shape != (EMBED_TEXTS, MXBAI["dim"]) or not np.isfinite(
            vecs).all():
        raise RuntimeError(f"path 14 (c): embeddings {vecs.shape}")
    # the port's f32 forward of the same GGUF on the CPU, 4 texts
    t0 = time.perf_counter()
    cpu = E.embed_batch(params_from_numpy(tree, "cpu"), ecfg,
                        [tok.encode(t) for t in texts[:4]], "cpu")
    out["cpu_forward_s"] = time.perf_counter() - t0
    cos, rel = cosine_rows(vecs[:4], cpu)
    # the peak on the card of the weights and one 64-text forward
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    params = params_from_numpy(tree, "cuda")
    del tree
    E.embed_batch(params, ecfg, [tok.encode(t) for t in texts])
    peak = torch.cuda.max_memory_allocated() - base
    del params
    torch.cuda.empty_cache()
    out.update(texts=EMBED_TEXTS, tokens=int(sum(lens)), wall_s=wall,
               texts_per_s=EMBED_TEXTS / wall,
               tokens_per_s=sum(lens) / wall, cut_at_512=sum(
                   len(tok.encode(t)) > 512 for t in texts),
               card_vs_cpu_cosine=[float(c) for c in cos],
               card_vs_cpu_rel=[float(r) for r in rel],
               peak_card_bytes=peak, n_params=ecfg.n_params)
    print(f"path 14 (c) [{card}]: {MXBAI_NAME} ({ecfg.n_params / 1e6:.0f}M "
          f"parameters) GGUF {g['bytes'] / 1e9:.3f} GB written in "
          f"{out['write_gguf_s']:.1f} s, uploaded in {out['upload_s']:.1f} s;"
          f" load {out['load_s']:.2f} s; /api/embed of {EMBED_TEXTS} texts "
          f"({sum(lens)} tokens, {out['cut_at_512']} cut at 512) in "
          f"{wall:.3f} s: {out['texts_per_s']:.1f} texts/s, "
          f"{out['tokens_per_s']:.0f} tokens/s; card vs the CPU's f32 "
          f"forward on 4 texts: cosine min {cos.min():.7f}, max |delta| "
          f"{rel.max():.3%} of max |x|; peak on the card (weights + one "
          f"64-text forward) {peak / 1e9:.2f} GB", flush=True)
    if not cos.min() >= 0.9999:
        raise RuntimeError(f"path 14 (c): the card's vectors differ from "
                           f"the CPU's f32 forward (cosine {cos})")
    return out


def moe_embed(torch, lm) -> dict:
    """Path 14 (d): one ``embed`` of 8 texts (110..300 byte tokens: the
    buckets 256 and 512, each batch above 256 rows, so the experts take
    their loop) on path 13's loaded qwen3moe: K1 at 32/4 heads launches,
    the vectors are finite."""
    import numpy as np
    from ollama_operator_tpu_torch.ops import cuda_build
    rng = np.random.default_rng(SEED + 17)
    texts = ["".join(rng.choice(list("abcdefgh "), int(n)))
             for n in rng.integers(110, 301, 8)]
    lens = [len(lm.tokenizer.encode(t)) for t in texts]
    for name in cuda_build.launches:
        cuda_build.launches[name] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vecs = lm.embed(texts)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = dict(cuda_build.launches)
    out = {"texts": len(texts), "token_lengths": lens, "wall_s": wall,
           "launches": launched, "finite": bool(np.isfinite(vecs).all()),
           "shape": list(vecs.shape)}
    print(f"path 14 (d): qwen3moe ({lm.cfg.n_layers} layers) embed of 8 "
          f"texts ({sum(lens)} tokens, buckets "
          f"{sorted({bucket_of(n) for n in lens})}) in {wall:.3f} s; "
          f"launches {launched}; finite {out['finite']}", flush=True)
    if not out["finite"] or launched.get("flash_prefill", 0) <= 0:
        raise RuntimeError(f"path 14 (d): {out}")
    return out



def gguf_tokenizer(path: str):
    """The tokenizer of a GGUF file's metadata."""
    from ollama_operator_tpu_torch.gguf.reader import GGUFFile
    from ollama_operator_tpu_torch.tokenizer import Tokenizer
    with GGUFFile(path) as f:
        return Tokenizer.from_gguf_metadata(
            {k: v for k, v in f.metadata.items()
             if k.startswith("tokenizer.")})


def embed_server_phases(torch, details, card: str, ms, ref: str, tokenizer,
                        workdir: str) -> dict:
    """Path 14 (a) and then (c) on the model server ``ms`` serving the
    llama3.2:3b GGUF ``ref``; their results and times go to
    ``details["embed_path"]``. Returns (a)'s."""
    ep = details.setdefault("embed_path", {})
    el = ep.setdefault("elapsed_s", {})
    t0 = time.perf_counter()
    ep["a"] = embed_phase(card, ms, ref, tokenizer)
    el["a"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ep["c"] = encoder_phase(torch, card, ms, workdir)
    el["c"] = time.perf_counter() - t0
    return ep["a"]


def embed_checks(torch, details, timer, report):
    """Path 14 (b) and the kernel rows at the embedding shapes: K1 and K7
    at (a)'s largest bucket, K8 at (b)'s [32, 512] batch."""
    t0 = time.perf_counter()
    ep = details.setdefault("embed_path", {})
    T, (_, rows) = max((int(T), v) for T, v in ep["a"]["buckets"].items())
    ep["b"] = [embed_cross_check(torch, details, "llama3.1", 4),
               embed_cross_check(torch, details, "llama3.2:3b", 8)]
    ep["kernel_rows"] = embed_kernel_rows(torch, timer, report, rows, 32, T)
    ep.setdefault("elapsed_s", {})["b"] = time.perf_counter() - t0


def embed_total(details) -> float:
    """Path 14's seconds in all, printed and recorded."""
    el = details["embed_path"]["elapsed_s"]
    el["total"] = sum(v for k, v in el.items() if k != "total")
    print(f"path 14 seconds: {el}", flush=True)
    return el["total"]


def created_model_server(workdir: str):
    """A model server on a store and cache in ``workdir`` whose
    llama3.2:3b (the GGUF written from the seed) was uploaded through
    /api/blobs and created by ``files``, in the place of path 9's pull:
    (the server, the GGUF's record, its digest). The caller stops the
    server."""
    from ollama_operator_tpu_torch.models.config import get_config
    g = write_gguf_model(os.path.join(workdir, "model.gguf"),
                         get_config(GGUF_MODEL))
    ms = PortServer(["--store", os.path.join(workdir, "store"),
                     "--cache", os.path.join(workdir, "cache")],
                    os.path.join(workdir, "model.log"))
    try:
        ms.wait_ready()
        digest = sha256_file(g["path"])
        if upload_blob(ms.port, g["path"], digest) != 201:
            raise RuntimeError("the GGUF upload failed")
        s, _, b = call(ms.port, "/api/create", {
            "model": GGUF_MODEL, "files": {"model.gguf": digest},
            "template": CHAT_TEMPLATE, "parameters": {"temperature": 0},
            "stream": False})
        if s != 200:
            raise RuntimeError(f"/api/create answered {s}: {b}")
    except BaseException:
        ms.stop()
        ms.log.close()
        raise
    return ms, g, digest


def embed_only(torch, details, card: str, timer, report):
    """``--embed-only``: path 14 alone. The llama3.2:3b GGUF is written
    from the seed, uploaded to a model server's store through /api/blobs
    and created by ``files`` (the authoring routes in the place of path
    9's pull), loaded, and (a) and (c) run on it; then (b), the kernel
    rows, and (d) on qwen3moe cut to 4 layers."""
    from ollama_operator_tpu_torch.server.app import ModelManager
    workdir = tempfile.mkdtemp(prefix="chip_smoke_embed_")
    ms = None
    try:
        t0 = time.perf_counter()
        ms, g, _ = created_model_server(workdir)
        tok = gguf_tokenizer(g["path"])
        s, _, b = call(ms.port, "/api/generate", {"model": GGUF_MODEL,
                                                  "prompt": ""})
        ps = ms.get("/api/ps")["models"][0]["details"]
        if s != 200 or (ps["serving_dtype"], ps["paged"]) != ("int8", True):
            raise RuntimeError(f"the created model loads as {s} {b} {ps}")
        print(f"embed-only: {GGUF_MODEL} written, uploaded, created and "
              f"loaded in {time.perf_counter() - t0:.1f} s", flush=True)
        launches = embed_server_phases(torch, details, card, ms, GGUF_MODEL,
                                       tok, workdir)["launches"]
    finally:
        if ms is not None:
            ms.stop()
            ms.log.close()
        shutil.rmtree(workdir, ignore_errors=True)
    embed_checks(torch, details, timer, report)
    cfg = dataclasses.replace(model_config("qwen3moe"), n_layers=4)
    mm = ModelManager()
    try:
        lm = mm.preload("qwen3moe", cfg, dense_params(torch, cfg),
                        byte_tokenizer(cfg.vocab_size))
        t0 = time.perf_counter()
        details["embed_path"]["d"] = moe_embed(torch, lm)
        details["embed_path"]["elapsed_s"]["d"] = time.perf_counter() - t0
    finally:
        mm.shutdown()
    embed_total(details)
    return launches

# ---------------------------------------------------------------------------
# Path 15: images through llava's vision tower, a LoRA adapter merged at
# load, and mirostat sampling
# ---------------------------------------------------------------------------

LLAVA_PATH = "llava int4, images through the CLIP tower: int8 paged (v3) KV"
LLAVA_COUNTERS = ("flash_prefill", "paged_decode", "qmm4")
LLAVA_ABSENT = ("qmm", "paged_decode_int4", "paged_decode_v2",
                "paged_decode_v4") + DENSE_COUNTERS
ADAPTER_PATH = ("llama3.2:3b GGUF with a rank-16 ADAPTER merged at load: "
                "int8 paged (v3) KV")
MIROSTAT_PATH = "llama3.2:3b GGUF, mirostat 1 and 2: int8 paged (v3) KV"
# CLIP ViT-L/14-336 as llava-1.5's mmproj stores it: 23 of its 24
# transformer layers (the converter drops the last, unused one), width
# 1024, 16 heads, ffn 4096, and the projector 1024 → 4096 → 4096
CLIP_L14_336 = dict(image_size=336, patch_size=14, width=1024, n_layers=23,
                    n_heads=16, ffn_dim=4096, proj_dim=4096)
LLAVA_TEMPLATE = "USER: {{ .Prompt }} ASSISTANT:"
LLAVA_BOS = 1
# the 8 /api/generate requests' images (height, width, PNG colour type:
# 2 RGB, 6 RGBA, 0 gray, 3 palette, 4 gray + alpha), square and not,
# up- and downscaled; the 2 chats' images (two per chat)
LLAVA_IMAGES = ((336, 336, 2), (480, 640, 6), (300, 200, 0), (768, 1024, 2),
                (512, 512, 3), (200, 300, 2), (600, 800, 4), (128, 96, 2))
CHAT_IMAGES = (((224, 224, 2), (400, 300, 6)), ((256, 192, 3), (90, 160, 2)))
LORA_RANK, LORA_ALPHA = 16, 32.0
LORA_TARGETS = ("attn_q", "attn_k", "attn_v", "attn_output", "ffn_gate",
                "ffn_up", "ffn_down")


def png_encode(samples, color_type: int, palette=None) -> bytes:
    """uint8 samples [H, W, channels] → an 8-bit PNG, row r under filter
    r % 5 (None, Sub, Up, Average, Paeth, each computed over the whole
    image from the raw rows)."""
    import struct
    import zlib

    import numpy as np
    h, w, ch = samples.shape
    raw = samples.reshape(h, w * ch).astype(np.int16)
    left = np.zeros_like(raw)
    left[:, ch:] = raw[:, :-ch]
    up = np.zeros_like(raw)
    up[1:] = raw[:-1]
    ul = np.zeros_like(raw)
    ul[1:, ch:] = raw[:-1, :-ch]
    p = left + up - ul
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - ul)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, ul))
    preds = np.stack([np.zeros_like(raw), left, up, (left + up) // 2,
                      paeth])
    ft = np.arange(h) % 5
    filt = ((raw - preds[ft, np.arange(h)]) & 255).astype(np.uint8)
    body = np.concatenate([ft[:, None].astype(np.uint8), filt], axis=1)

    def chunk(kind, data):
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data)))
    out = b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
    if palette is not None:
        out += chunk(b"PLTE", palette.astype(np.uint8).tobytes())
    out += chunk(b"IDAT", zlib.compress(body.tobytes(), 1))
    return out + chunk(b"IEND", b"")


def seeded_png(h: int, w: int, color_type: int, seed: int) -> bytes:
    """A PNG made from the seed: smooth colour gradients under noise."""
    import numpy as np
    rng = np.random.default_rng(seed)
    ch = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color_type]
    yy, xx = np.mgrid[0:h, 0:w]
    base = [(np.sin(xx / (7 + 9 * c) + c) * np.cos(yy / (11 + 5 * c))
             * 100 + 128) for c in range(ch)]
    img = np.stack(base, -1) + rng.normal(0, 20, (h, w, ch))
    img = np.clip(img, 0, 255).astype(np.uint8)
    if color_type == 3:
        return png_encode(img, 3, rng.integers(0, 256, (256, 3)))
    return png_encode(img, color_type)


def write_mmproj(torch, path: str, vcfg) -> dict:
    """The llava mmproj GGUF (llama.cpp's clip names, arch "clip") of a
    tower at ``vcfg``'s widths, f16 tensors from the seed (drawn on the
    card): matrices normal with std 0.02, biases std 0.02, norm weights
    1 + N(0, 0.02)."""
    from ollama_operator_tpu_torch.gguf.writer import GGUFWriter
    g = torch.Generator(device="cuda").manual_seed(SEED + 150)
    W, Fd, P, L = vcfg.width, vcfg.ffn_dim, vcfg.patch_size, vcfg.n_layers
    w = GGUFWriter(path)
    for k, v in (("general.architecture", "clip"),
                 ("clip.vision.image_size", vcfg.image_size),
                 ("clip.vision.patch_size", P),
                 ("clip.vision.embedding_length", W),
                 ("clip.vision.feed_forward_length", Fd),
                 ("clip.vision.block_count", L),
                 ("clip.vision.attention.head_count", vcfg.n_heads),
                 ("clip.vision.attention.layer_norm_epsilon",
                  vcfg.norm_eps)):
        w.add_meta(k, v)
    n = 0

    def put(name, *shape, mean=0.0):
        nonlocal n
        a = torch.randn(shape, generator=g, device="cuda") * 0.02 + mean
        w.add_tensor_f16(name, a.half().cpu().numpy())
        n += a.numel()
    put("v.patch_embd.weight", W, 3, P, P)
    put("v.class_embd", W)
    put("v.position_embd.weight", 1 + vcfg.n_patches, W)
    put("v.pre_ln.weight", W, mean=1.0)
    put("v.pre_ln.bias", W)
    for i in range(L):
        pre = f"v.blk.{i}."
        for nm in ("ln1", "ln2"):
            put(pre + nm + ".weight", W, mean=1.0)
            put(pre + nm + ".bias", W)
        for nm in ("attn_q", "attn_k", "attn_v", "attn_out"):
            put(pre + nm + ".weight", W, W)
            put(pre + nm + ".bias", W)
        put(pre + "ffn_up.weight", Fd, W)
        put(pre + "ffn_up.bias", Fd)
        put(pre + "ffn_down.weight", W, Fd)
        put(pre + "ffn_down.bias", W)
    put("mm.0.weight", vcfg.proj_dim, W)
    put("mm.0.bias", vcfg.proj_dim)
    put("mm.2.weight", vcfg.proj_dim, vcfg.proj_dim)
    put("mm.2.bias", vcfg.proj_dim)
    w.write()
    return {"path": path, "params": n, "bytes": os.path.getsize(path)}


def llava_phase(torch, details, card: str, workdir: str) -> dict:
    """Path 15 (a): llava at full width and depth (the ``llava`` preset:
    vicuna-7b's 32 layers, dim 4096, 32/32 heads, hd 128, ffn 11008,
    vocab 32000; random bf16 weights from the seed through
    ``ModelManager.preload``, served in the int4 its 6.74e9 parameters
    resolve to, on the MHA paged defaults: an int8 pool of 32 slots on
    64-row pages) with a vision tower loaded from an mmproj GGUF written
    from the seed at CLIP ViT-L/14-336's widths (bf16 on the card, as the
    server loads it), behind the HTTP server. 8 concurrent greedy
    /api/generate requests of one PNG each (8 prompts of one length, 8
    images: square and not, every colour type), 2 /api/chat requests with an image in
    each of two messages, and the 2 text-only twins beside them: each
    image adds exactly 576 prompt tokens; K1, K6 and K8 launch, no other
    kernel. Then two image requests' served tokens against the engine's
    calls for them replayed teacher-forced on the kernel path (their
    recorded spliced embeddings), a two-layer kernel-against-plain
    cross-check fed one of those embeddings, and the tower in bf16
    against the same GGUF's weights in f32 on the card (each image-token
    row at cosine >= 0.999). Returns the 12 requests' launch counts."""
    import base64
    import gc

    import numpy as np
    from ollama_operator_tpu_torch.convert import params_from_numpy
    from ollama_operator_tpu_torch.gguf.reader import GGUFFile
    from ollama_operator_tpu_torch.gguf.transcode import (
        load_vision_params, vision_config_from_gguf)
    from ollama_operator_tpu_torch.models import vision as V
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import cuda_build
    from ollama_operator_tpu_torch.runtime.engine import resolve_engine_dtype
    from ollama_operator_tpu_torch.server import images as I
    from ollama_operator_tpu_torch.server.app import ModelManager, serve
    cfg = get_config("llava")
    out = {"model": "llava", "card": card}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    vcfg0 = V.VisionConfig(**CLIP_L14_336)
    g = write_mmproj(torch, os.path.join(workdir, "mmproj.gguf"), vcfg0)
    out["mmproj"] = dict(g, write_s=time.perf_counter() - t0)
    t0 = time.perf_counter()
    with GGUFFile(g["path"]) as f:
        vcfg = vision_config_from_gguf(f)
        vparams = params_from_numpy(load_vision_params(f, vcfg, "bfloat16"),
                                    "cuda")
    out["tower_load_s"] = time.perf_counter() - t0
    if (vcfg.n_patches, vcfg.n_run, vcfg.proj_dim) != (
            vcfg0.n_patches, vcfg0.n_layers, cfg.dim):
        raise RuntimeError(f"the tower loads as {vcfg}")
    n_img = vcfg.n_patches      # 576 image tokens
    t0 = time.perf_counter()
    mm = ModelManager()
    lm = mm.preload("llava", cfg, dense_params(torch, cfg),
                    byte_tokenizer(cfg.vocab_size, bos=LLAVA_BOS),
                    dtype=resolve_engine_dtype(cfg, "cuda"),
                    template=LLAVA_TEMPLATE, vision=(vcfg, vparams))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out["build_s"] = time.perf_counter() - t0
    e = lm.ecfg
    if (lm.serving_dtype, lm.engine.paged, e.page_size, e.max_slots) != (
            "int4", True, 64, 32):
        raise RuntimeError(f"llava serves {lm.serving_dtype}, paged "
                           f"{lm.engine.paged}, {e}")
    print(f"serving {LLAVA_PATH}: slots={e.max_slots} page_size="
          f"{e.page_size} pages={e.n_pages} max_seq={e.max_seq_len} "
          f"chunk={e.decode_chunk}; tower {vcfg.n_run} layers, "
          f"{g['params'] / 1e9:.3f}e9 parameters ({g['bytes'] / 1e9:.3f} GB "
          f"f16 GGUF written in {out['mmproj']['write_s']:.1f} s, loaded "
          f"in {out['tower_load_s']:.1f} s); build {out['build_s']:.1f} s",
          flush=True)
    pngs = [seeded_png(h, w, ct, SEED + i)
            for i, (h, w, ct) in enumerate(LLAVA_IMAGES)]
    chat_pngs = [[seeded_png(h, w, ct, SEED + 20 + 2 * i + j)
                  for j, (h, w, ct) in enumerate(pair)]
                 for i, pair in enumerate(CHAT_IMAGES)]
    b64 = [base64.b64encode(p).decode() for p in pngs]
    decoded = [I.decode_image(p) for p in pngs]
    # the tower's time an image: the host's decode and resize, then the
    # tower and projector on the card
    tower = []
    for p, img in zip(pngs[:4], decoded):
        t0 = time.perf_counter()
        x = I.preprocess(I.decode_image(p), vcfg.image_size)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with torch.inference_mode():
            V.encode(vcfg, vparams, torch.from_numpy(x[None]).to("cuda"))
        torch.cuda.synchronize()
        tower.append({"hw": list(img.shape[:2]),
                      "host_decode_resize_ms": (t1 - t0) * 1e3,
                      "tower_ms": (time.perf_counter() - t2) * 1e3})
    out["tower_per_image"] = tower
    # the spliced admissions the engine runs, recorded for the replays
    admitted = []
    real_admit = lm.engine.admit

    def admit(slot, prompt, *a, **kw):
        tok = real_admit(slot, prompt, *a, **kw)
        if kw.get("embeds") is not None:
            admitted.append((np.asarray(prompt).tolist(),
                             kw["embeds"].clone(), tok))
        return tok
    lm.engine.admit = admit
    httpd = serve(mm, "127.0.0.1", 0)
    port = httpd.server_address[1]
    # greedy over the raw logits, so that a replay's argmax is the token
    opts = {"temperature": 0, "num_predict": 32, "repeat_penalty": 1.0}
    # one prompt text a request, all of one length (the byte tokenizer
    # gives a token a byte): one text twin counts for all 8
    prompts = [f"describe picture {i}: what it shows, and its colours"
               for i in range(8)]
    chat_msgs = [[{"role": "user", "content": "look at this first",
                   "images": [base64.b64encode(p).decode()
                              for p in pair[:1]]},
                  {"role": "assistant", "content": "I see it"},
                  {"role": "user", "content": "and compare it with this",
                   "images": [base64.b64encode(p).decode()
                              for p in pair[1:]]}]
                 for pair in chat_pngs]
    twin_msgs = [{k: v for k, v in m.items() if k != "images"}
                 for m in chat_msgs[0]]
    try:
        http(port, "/api/generate", {"model": "llava", "prompt": "warm up",
                                     "images": [b64[7]], "options": dict(
                                         opts, num_predict=2)})
        torch.cuda.synchronize()
        admitted.clear()
        for name in cuda_build.launches:
            cuda_build.launches[name] = 0
        calls = ([lambda p=p, b=b: http(port, "/api/generate", {
            "model": "llava", "prompt": p, "images": [b],
            "options": opts}) for p, b in zip(prompts, b64)]
            + [lambda m=m: http(port, "/api/chat", {
                "model": "llava", "messages": m, "options": opts})
               for m in chat_msgs]
            + [lambda: http(port, "/api/generate", {
                "model": "llava", "prompt": prompts[0], "options": opts}),
               lambda: http(port, "/api/chat", {
                   "model": "llava", "messages": twin_msgs,
                   "options": opts})])
        results, wall = concurrent(calls)
        launches = dict(cuda_build.launches)
    finally:
        lm.engine.admit = real_admit
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()
    finals = [frames[-1] for _, frames, _ in results]
    for i, f in enumerate(finals):
        if not f.get("done") or f.get("eval_count") != 32:
            raise RuntimeError(f"path 15 (a) request {i} ended {f}")
    n_text, n_chat = finals[10]["prompt_eval_count"], finals[11][
        "prompt_eval_count"]
    counts = [f["prompt_eval_count"] for f in finals]
    want = [n_text + n_img] * 8 + [n_chat + 2 * n_img] * 2 + [n_text,
                                                              n_chat]
    if counts != want:
        raise RuntimeError(f"path 15 (a) prompt_eval_count {counts}, want "
                           f"{want} ({n_img} a image)")
    missing = [k for k in LLAVA_COUNTERS if launches[k] <= 0]
    stray = [k for k in LLAVA_ABSENT if launches[k] != 0]
    if missing or stray:
        raise RuntimeError(f"path 15 (a) launches {launches}: not launched "
                           f"{missing}, of another path {stray}")
    if len(admitted) != 10:
        raise RuntimeError(f"{len(admitted)} spliced admissions, want 10")
    streams = [f["context"][n_text:] for f in finals[:8]]
    n_tok = sum(f["eval_count"] for f in finals[:8])
    ttft = [f["prompt_eval_duration"] / 1e6 for f in finals]
    out.update(requests=len(finals), wall_s=wall, launches=launches,
               generated_tokens_8=n_tok, aggregate_tok_s_8=n_tok / wall,
               prompt_tokens=counts, ttft_ms_image=sorted(ttft[:10]),
               ttft_ms_text_twins=ttft[10:],
               distinct_image_streams=len({tuple(s) for s in streams}),
               peak_memory_bytes=torch.cuda.max_memory_allocated())
    t = sorted(ttft[:8])
    print(f"path 15 (a) [{card}]: 8 /api/generate with one image each + 2 "
          f"/api/chat with two + 2 text twins, x 32 tokens in {wall:.3f} s: "
          f"{n_tok / wall:.1f} tok/s over the 8; prompt tokens {counts}; "
          f"TTFT ms image median {t[4]:.1f} max {t[-1]:.1f}, text twins "
          f"{[round(x, 1) for x in ttft[10:]]}; "
          f"{out['distinct_image_streams']} distinct streams of the 8; "
          f"tower a image {[round(x['tower_ms'], 2) for x in tower]} ms "
          f"(host decode + resize "
          f"{[round(x['host_decode_resize_ms'], 1) for x in tower]} ms); "
          f"launches {launches}; peak {out['peak_memory_bytes'] / 1e9:.2f} "
          f"GB", flush=True)

    # the served tokens of two image requests against the engine's calls
    # for them replayed teacher-forced on the kernel path, fed the
    # embeddings their admissions recorded (found by the padded ids, which
    # differ by the prompt); the same splice again here, from the decoded
    # image, says whether the tower repeats its bits
    replays = []
    for i in (0, 3):
        text = lm.tokenizer.encode(lm.render_prompt(prompts[i]))
        ids, again = lm.splice_images(text, [decoded[i]])
        rec = [a for a in admitted if a[0] == ids]
        if len(rec) != 1:
            raise RuntimeError(f"path 15 (a): request {i}'s padded ids "
                               f"match {len(rec)} recorded admissions")
        _, emb, first = rec[0]
        served = streams[i]
        if first != served[0]:
            raise RuntimeError(f"path 15 (a): request {i}'s admission gave "
                               f"{first}, its stream {served[0]}")
        _, replayed = teacher_forced(
            torch, cfg, lm.engine.params, ids, len(served) - 1, "int8",
            teacher=served, engine=lm.engine, piece=len(ids), embeds=emb)
        equal = sum(a == b for a, b in zip(served, replayed))
        replays.append({"request": i, "prompt_tokens": len(ids),
                        "equal": equal, "served": served,
                        "splice_repeats_its_bits": bool(torch.equal(
                            again, emb))})
        if replayed != served:
            raise RuntimeError(f"path 15 (a): request {i}'s served tokens "
                               f"{served} differ from the replayed kernel "
                               f"path's {replayed}")
    out["replay"] = replays
    print(f"path 15 (a) replay of requests 0 and 3 (teacher-forced on the "
          f"kernel path, their recorded spliced embeddings): equal at "
          f"{[r['equal'] for r in replays]}/32 steps; the splice again "
          f"gives the same bits: "
          f"{[r['splice_repeats_its_bits'] for r in replays]}", flush=True)
    cross_ids, cross_emb = admitted[0][0], admitted[0][1]
    # the tower in bf16 (served) against f32 weights of the same GGUF
    with GGUFFile(g["path"]) as f:
        v32 = params_from_numpy(load_vision_params(f, vcfg, "float32"),
                                "cuda")
    x = torch.from_numpy(np.stack([I.preprocess(d, vcfg.image_size)
                                   for d in decoded[:2]])).to("cuda")
    with torch.inference_mode():
        a, b = V.encode(vcfg, vparams, x), V.encode(vcfg, v32, x)
    cos = torch.nn.functional.cosine_similarity(a, b, dim=-1)
    out["tower_bf16_vs_f32_min_cosine"] = cos.min().item()
    print(f"path 15 (a) tower bf16 vs f32 weights on the card: min cosine "
          f"over {cos.numel()} image-token rows {cos.min().item():.6f}",
          flush=True)
    if cos.min().item() < 0.999:
        raise RuntimeError(f"the bf16 tower moves from the f32 one: cosine "
                           f"{cos.min().item()}")
    del v32, x, a, b, lm, vparams
    gc.collect()
    torch.cuda.empty_cache()
    cross_check(torch, details, "llava", 4, "int8", ids=cross_ids,
                embeds=cross_emb, expect=LLAVA_COUNTERS)
    del admitted, cross_emb
    details.setdefault("path15", {})["a"] = out
    return launches


def write_adapter(path: str, cfg) -> dict:
    """A rank-16 LoRA GGUF from the seed for all seven projections of every
    layer of ``cfg``: A [r, in] and B [out, r] f32, std 0.025 each (a
    delta of std ~0.003 against weights of ~0.02), alpha 32."""
    import numpy as np
    from ollama_operator_tpu_torch.gguf.writer import GGUFWriter
    rng = np.random.default_rng(SEED + 160)
    D, F, q, kv = cfg.dim, cfg.ffn_dim, cfg.q_dim, cfg.kv_dim
    shapes = {"attn_q": (q, D), "attn_k": (kv, D), "attn_v": (kv, D),
              "attn_output": (D, q), "ffn_gate": (F, D), "ffn_up": (F, D),
              "ffn_down": (D, F)}
    w = GGUFWriter(path)
    w.add_meta("general.architecture", "llama")
    w.add_meta("general.type", "adapter")
    w.add_meta("adapter.type", "lora")
    w.add_meta("adapter.lora.alpha", LORA_ALPHA)
    for i in range(cfg.n_layers):
        for t in LORA_TARGETS:
            out_, in_ = shapes[t]
            w.add_tensor_f32(f"blk.{i}.{t}.weight.lora_a", (
                rng.standard_normal((LORA_RANK, in_), dtype=np.float32)
                * 0.025))
            w.add_tensor_f32(f"blk.{i}.{t}.weight.lora_b", (
                rng.standard_normal((out_, LORA_RANK), dtype=np.float32)
                * 0.025))
    w.write()
    return {"path": path, "bytes": os.path.getsize(path)}


def _raw_prompt(i: int, n: int) -> str:
    """Distinct raw prompts of a few words (under 16 tokens): nothing of
    one is a cached prefix of another, nor of its repeat (a page is 128
    positions)."""
    return " ".join(GGUF_WORDS[(5 * i + j) % len(GGUF_WORDS)]
                    for j in range(n))


# path 15 (b)'s requests, sent to the base model and to the tuned one: 4
# greedy ones (replayed), and 2 seeded at temperature 1 (compared): the
# seeded GGUF's greedy streams settle on one token in a few steps, the
# same one with the adapter or without (measured on a 4-layer, 768-wide
# cut on the CPU), while a sampled stream follows the whole distribution
ADAPTER_OPTIONS = ([{"temperature": 0, "num_predict": 32,
                     "repeat_penalty": 1.0}] * 4
                   + [{"temperature": 1.0, "seed": 70 + i, "num_predict": 32,
                       "repeat_penalty": 1.0} for i in range(2)])
ADAPTER_PROMPTS = [_raw_prompt(10 + i, 6 + 2 * (i % 4))
                   for i in range(len(ADAPTER_OPTIONS))]


def adapter_requests(model: str):
    return [{"model": model, "prompt": p, "raw": True, "context": [],
             "stream": False, "options": o}
            for p, o in zip(ADAPTER_PROMPTS, ADAPTER_OPTIONS)]


def mirostat_phase(card: str, ms, ref: str, cfg) -> dict:
    """Path 15 (c) on path 9's model server ``ms`` (its base model
    resident): 2 seeded requests each of mirostat 1 and 2 (tau 5, eta
    0.1, temperature 1, no repeat penalty), 64 tokens, all four at once
    and then again: each stream repeats itself, every token in the
    vocabulary; the launch counts from the server's /api/ps just before
    and after them. Then (b)'s requests on the base model, for (b) to
    differ from."""
    out = {"card": card}
    port = ms.port
    post(port, {"model": ref, "prompt": "", "stream": False})   # resident
    before = ms.launches()
    # raw, with an empty context: the final frame carries the tokens
    mir = [{"model": ref, "prompt": _raw_prompt(i, 4), "raw": True,
            "context": [], "stream": False, "options": {
                "mirostat": 1 + i // 2, "mirostat_tau": 5.0,
                "mirostat_eta": 0.1, "temperature": 1.0, "seed": 100 + i,
                "repeat_penalty": 1.0, "num_predict": 64}}
           for i in range(4)]
    t0 = time.perf_counter()
    first, wall = concurrent([lambda b=b: post(port, b) for b in mir])
    again, _ = concurrent([lambda b=b: post(port, b) for b in mir])
    after = ms.launches()
    out["mirostat"] = {
        "requests": mir, "wall_s": wall,
        "phase_s": time.perf_counter() - t0,
        "streams": [f["context"] for f in first],
        "prompt_tokens": [f["prompt_eval_count"] for f in first],
        "repeats_equal": sum(a["context"] == b["context"]
                             for a, b in zip(first, again)),
        "launches": {k: after[k] - before[k] for k in after}}
    V = cfg.vocab_size
    for f in first:
        if f.get("eval_count") != 64 or not all(
                0 <= t < V for t in f["context"]):
            raise RuntimeError(f"path 15 (c) stream {f}")
    if out["mirostat"]["repeats_equal"] != 4:
        raise RuntimeError("path 15 (c): a seeded mirostat stream did not "
                           "repeat itself")
    print(f"path 15 (c) [{card}]: 2 x mirostat 1 + 2 x mirostat 2 (tau 5, "
          f"eta 0.1), 64 tokens, in {wall:.3f} s; each repeats itself "
          f"(4/4); launches {out['mirostat']['launches']}", flush=True)
    base, _ = concurrent([lambda b=b: post(port, b)
                          for b in adapter_requests(ref)])
    out["base"] = [f["context"] for f in base]
    return out


def adapter_phase(card: str, ms, ref: str, workdir: str, store: str, cfg,
                  base) -> dict:
    """Path 15 (b) on path 9's model server ``ms`` (its store at
    ``store``): a rank-16 adapter GGUF from the seed uploaded through
    /api/blobs and created with ``FROM <path 9's model>`` and ``ADAPTER``
    (the uploaded blob's path on the server), loaded (from the transcode
    cache, then the merge), and the requests that (c) sent to the base
    model (``base``, their contexts): 4 greedy, and 2 seeded samples,
    which must differ from the base model's; K7 launches."""
    out = {"card": card}
    port = ms.port
    t0 = time.perf_counter()
    a = write_adapter(os.path.join(workdir, "adapter.gguf"), cfg)
    digest = sha256_file(a["path"])
    if upload_blob(port, a["path"], digest) != 201:
        raise RuntimeError("the adapter upload failed")
    blob = os.path.join(store, "blobs", digest.replace(":", "-"))
    out["adapter"] = {"bytes": a["bytes"], "digest": digest, "blob": blob,
                      "write_upload_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    s, _, body = call(port, "/api/create", {
        "model": "llama3.2-tuned", "modelfile":
            f"FROM {ref}\nADAPTER {blob}\n", "stream": False})
    out["adapter"]["create_s"] = time.perf_counter() - t0
    if s != 200:
        raise RuntimeError(f"/api/create with ADAPTER answered {s}: {body}")
    before = ms.launches()
    t0 = time.perf_counter()
    s, _, body = call(port, "/api/generate", {"model": "llama3.2-tuned",
                                              "prompt": ""})
    out["adapter"]["load_s"] = time.perf_counter() - t0
    if s != 200:
        raise RuntimeError(f"the adapter model loads as {s}: {body}")
    tuned, wall = concurrent([lambda b=b: post(port, b)
                              for b in adapter_requests("llama3.2-tuned")])
    after = ms.launches()
    differ = [x["context"] != y for x, y in zip(tuned, base)]
    out["adapter"].update(
        prompts=ADAPTER_PROMPTS, options=ADAPTER_OPTIONS, wall_s=wall,
        launches={k: after[k] - before[k] for k in after},
        tuned=[f["context"] for f in tuned],
        prompt_tokens=[f["prompt_eval_count"] for f in tuned],
        greedy_differ_from_base=sum(differ[:4]),
        sampled_differ_from_base=sum(differ[4:]))
    if out["adapter"]["launches"]["qmm"] <= 0:
        raise RuntimeError(f"path 15 (b): K7 not launched "
                           f"({out['adapter']['launches']})")
    if not all(differ[4:]):
        raise RuntimeError("path 15 (b): a seeded stream of the adapter "
                           "model is the base model's")
    print(f"path 15 (b) [{card}]: rank-{LORA_RANK} adapter "
          f"({a['bytes'] / 1e6:.1f} MB) uploaded and created in "
          f"{out['adapter']['write_upload_s']:.1f} + "
          f"{out['adapter']['create_s']:.2f} s, loaded (transcode cache + "
          f"merge) in {out['adapter']['load_s']:.1f} s; of the base "
          f"model's streams, the 2 seeded ones differ 2/2, the 4 greedy "
          f"{out['adapter']['greedy_differ_from_base']}/4; launches "
          f"{out['adapter']['launches']}", flush=True)
    return out


def mirostat_adapter_checks(torch, details, card: str, blob: str,
                            cache: str, digest: str, rec: dict,
                            base_lm=None) -> dict:
    """In this process, on the server's weights (``load_model`` of path
    9's GGUF from the server's transcode cache, int8 at the server's
    engine settings; ``base_lm``: such a model already resident, path 9's
    gate): (c) two mirostat streams (one of each version) replayed
    teacher-forced on the kernel path, the truncation and the budget
    recomputed at every step from the replayed logits: every served token
    lies inside its step's kept set, and the observed surprise of the
    last 32 tokens is recorded; (b) the adapter merged here on the card
    from the adapter's tensors (its time recorded), two of the served
    tuned streams equal to that model's calls replayed teacher-forced, and
    the port's ``apply_lora`` on the first and last layers equal to that
    merge."""
    import gc
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    from ollama_operator_tpu_torch.convert import (params_from_numpy,
                                                   tensor_from_numpy)
    from ollama_operator_tpu_torch.gguf import dequant as DQ
    from ollama_operator_tpu_torch.gguf.lora import apply_lora
    from ollama_operator_tpu_torch.gguf.writer import GGUFWriter
    from ollama_operator_tpu_torch.gguf.transcode import (_unpermute_rope,
                                                          load_model)
    from ollama_operator_tpu_torch.gguf.reader import GGUFFile
    from ollama_operator_tpu_torch.ops import sampling as S
    from ollama_operator_tpu_torch.runtime.engine import (
        EngineConfig, resolve_kv_dtype_default, resolve_serving_defaults)
    from ollama_operator_tpu_torch.server.app import (ModelManager,
                                                      transcode_dtype)
    from ollama_operator_tpu_torch.tokenizer import Tokenizer

    def load():
        gcfg, params, tok_md = load_model(
            blob, cache_dir=cache, dtype=transcode_dtype("int8", "cuda"),
            digest=digest.replace("sha256:", "")[:24])
        ecfg = resolve_serving_defaults(EngineConfig(
            max_slots=0, max_seq_len=4096, decode_chunk=0, page_size=0,
            paged=None, n_pages=None,
            cache_dtype=resolve_kv_dtype_default("cuda")), gcfg, "cuda")
        return gcfg, params, Tokenizer.from_gguf_metadata(tok_md), ecfg

    def served_model(gcfg, tparams, tok, ecfg):
        mm = ModelManager()
        lm = mm.preload(GGUF_MODEL, gcfg, tparams, tok, dtype="int8",
                        ecfg=ecfg)
        mm.shutdown()      # the scheduler stops; the engine stays
        return lm

    out = {}
    gcfg, params, tok, ecfg = load()
    lm = base_lm or served_model(gcfg, params_from_numpy(params, "cuda"),
                                 tok, ecfg)
    if lm.ecfg != ecfg:
        raise RuntimeError("the resident model is not at the server's "
                           "settings")
    V = gcfg.vocab_size
    mir = []
    for i in (0, 2):
        req = rec["mirostat"]["requests"][i]
        o = req["options"]
        ctx = rec["mirostat"]["streams"][i]
        n = rec["mirostat"]["prompt_tokens"][i]
        ids, served = ctx[:n], ctx[n:]
        logits, _ = teacher_forced(
            torch, gcfg, lm.engine.params, ids, len(served) - 1, "int8",
            teacher=served, engine=lm.engine, piece=lm.scheduler.prefill_chunk)
        sp = S.SamplingParams.from_rows([dict(
            temperature=o["temperature"], top_k=40, top_p=0.9, min_p=0.0,
            typical_p=1.0, repeat_penalty=1.0, presence_penalty=0.0,
            frequency_penalty=0.0, mirostat=o["mirostat"],
            mirostat_tau=o["mirostat_tau"],
            mirostat_eta=o["mirostat_eta"])], "cuda")
        mu = torch.full((1,), 2 * o["mirostat_tau"], device="cuda")
        e_obs, outside = [], []
        for t, tok_t in enumerate(served):
            vals, cand = torch.topk(logits[t:t + 1], S.N_CANDIDATES, dim=-1)
            scaled = vals / o["temperature"]
            keep = S.mirostat_keep(scaled, sp, mu, V)
            probs = S.renormalised(torch.where(
                keep, scaled, torch.full_like(scaled, S.NEG_INF)))
            hit = (cand[0] == tok_t).nonzero()
            if len(hit) == 0 or not keep[0, hit[0, 0]]:
                outside.append(t)
                break
            ci = hit[0]
            e_obs.append(-float(np.log2(max(probs[0, ci].item(), 1e-30))))
            mu = S.mirostat_update(mu, probs, ci, sp)
        mir.append({"request": i, "mirostat": o["mirostat"],
                    "kept_steps": len(e_obs), "outside_steps": outside,
                    "mean_surprise_last_32": (sum(e_obs[-32:]) / 32
                                              if len(e_obs) >= 32 else None),
                    "final_mu": mu.item()})
        if outside:
            raise RuntimeError(f"path 15 (c): stream {i}'s token at step "
                               f"{outside[0]} lies outside its mirostat "
                               f"truncation on the replayed logits")
    out["mirostat"] = mir
    print(f"path 15 (c) [{card}] replayed: every served token inside its "
          f"step's truncation; mean surprise of the last 32 tokens "
          f"(mirostat 1, 2; tau 5): "
          f"{[round(m['mean_surprise_last_32'], 3) for m in mir]} bits",
          flush=True)
    del lm, base_lm
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the served tuned streams against the adapter merged here, on the
    # card (each delta made as apply_lora makes it, (alpha / r) · B@A in
    # numpy with the q/k rope rows un-permuted, then rounded to the
    # weights' dtype and added in it), replayed teacher-forced; and
    # apply_lora itself on the first and last layers (a two-layer tree and
    # those layers' adapter tensors) equal to that merge
    adapter = rec["adapter"]["blob"]
    keys = dict(zip(LORA_TARGETS, ("wq", "wk", "wv", "wo", "w_gate", "w_up",
                                   "w_down")))
    ends = (0, gcfg.n_layers - 1)
    t0 = time.perf_counter()
    tparams = params_from_numpy(params, "cuda")
    mini = tempfile.mkdtemp(prefix="chip_smoke_lora_")
    try:
        with GGUFFile(adapter) as f:
            alpha = float(f.metadata["adapter.lora.alpha"])

            def lora(name):
                return np.asarray(DQ.dequantize_tensor(f, f.tensors[name]),
                                  np.float32)
            small = GGUFWriter(os.path.join(mini, "ends.gguf"))
            for k in ("general.architecture", "adapter.type",
                      "adapter.lora.alpha"):
                small.add_meta(k, f.metadata[k])
            def delta(job):
                i, t = job
                A = lora(f"blk.{i}.{t}.weight.lora_a")
                B = lora(f"blk.{i}.{t}.weight.lora_b")
                d = (alpha / A.shape[0]) * (B @ A)            # [out, in]
                if t in ("attn_q", "attn_k"):
                    d = _unpermute_rope(d, gcfg.n_heads if t == "attn_q"
                                        else gcfg.n_kv_heads)
                return i, t, A, B, d
            jobs = [(i, t) for i in range(gcfg.n_layers) for t in keys]
            # the deltas on a few host threads, each added on the card as
            # it comes
            with ThreadPoolExecutor(4) as pool:
                for i, t, A, B, d in pool.map(delta, jobs):
                    w = tparams["layers"][keys[t]]
                    w[i] += torch.from_numpy(d).to("cuda").t().to(w.dtype)
                    if i in ends:
                        j = ends.index(i)
                        small.add_tensor_f32(f"blk.{j}.{t}.weight.lora_a", A)
                        small.add_tensor_f32(f"blk.{j}.{t}.weight.lora_b", B)
            small.write()
        out["merge_on_card_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        two = apply_lora({"layers": {k: np.asarray(params["layers"][k])[
            list(ends)] for k in keys.values()}}, gcfg,
            os.path.join(mini, "ends.gguf"))
        out["apply_lora_two_layers_s"] = time.perf_counter() - t0
    finally:
        shutil.rmtree(mini, ignore_errors=True)
    checked = 0
    for key in keys.values():
        for j, i in enumerate(ends):
            got = tensor_from_numpy(two["layers"][key][j], "cuda")
            if not torch.equal(got, tparams["layers"][key][i]):
                raise RuntimeError(f"path 15 (b): apply_lora's {key}[{i}] "
                                   f"is not the merge made here")
            checked += 1
    out["weights_checked"] = checked
    del params, two
    lm = served_model(gcfg, tparams, tok, ecfg)
    del tparams
    reps = []
    for i in (0, 3):
        ctx = rec["adapter"]["tuned"][i]
        n = rec["adapter"]["prompt_tokens"][i]
        ids, served = ctx[:n], ctx[n:]
        _, replayed = teacher_forced(
            torch, gcfg, lm.engine.params, ids, len(served) - 1, "int8",
            teacher=served, engine=lm.engine, piece=lm.scheduler.prefill_chunk)
        reps.append(sum(a == b for a, b in zip(served, replayed)))
        if replayed != served:
            raise RuntimeError(f"path 15 (b): tuned stream {i} {served} "
                               f"differs from the replayed merged model's "
                               f"{replayed}")
    out["replay_equal"] = reps
    print(f"path 15 (b) [{card}] in this process: the adapter merged on "
          f"the card in {out['merge_on_card_s']:.2f} s; apply_lora on the "
          f"first and last layers ({out['apply_lora_two_layers_s']:.2f} s) "
          f"equal to it at {checked} projections; tuned streams 0 and 3 "
          f"equal their teacher-forced replay at {reps}/32 steps",
          flush=True)
    del lm
    gc.collect()
    torch.cuda.empty_cache()
    details.setdefault("path15", {}).update(checks=out)
    return out


def vision_only(torch, details, card: str):
    """``--vision-only``: path 15 alone. (a) llava; then (c) and (b) on a
    model server whose llama3.2:3b GGUF (written from the seed) was
    uploaded through /api/blobs and created by ``files`` (in the place of
    path 9's pull), and their checks in this process."""
    from ollama_operator_tpu_torch.models.config import get_config
    workdir = tempfile.mkdtemp(prefix="chip_smoke_vision_")
    el = details.setdefault("path15", {}).setdefault("elapsed_s", {})
    ms = None
    try:
        t0 = time.perf_counter()
        llava_phase(torch, details, card, workdir)
        el["a"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cfg = get_config(GGUF_MODEL)
        store, cache = (os.path.join(workdir, "store"),
                        os.path.join(workdir, "cache"))
        ms, _, digest = created_model_server(workdir)
        el["setup"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p15 = mirostat_phase(card, ms, GGUF_MODEL, cfg)
        el["c_server"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        p15.update(adapter_phase(card, ms, GGUF_MODEL, workdir, store, cfg,
                                 p15["base"]))
        el["b_server"] = time.perf_counter() - t0
        if ms.stop() != 0:
            raise RuntimeError(f"model server stopped badly: {ms.tail()}")
        t0 = time.perf_counter()
        mirostat_adapter_checks(torch, details, card, os.path.join(
            store, "blobs", digest.replace(":", "-")), cache, digest, p15)
        el["bc_checks"] = time.perf_counter() - t0
        details["path15"]["server"] = p15
    finally:
        if ms is not None:
            ms.stop()
            ms.log.close()
        shutil.rmtree(workdir, ignore_errors=True)
    print(f"path 15 seconds: {el}", flush=True)


def dispatch_steps(torch, engine, slot_opts, n: int = 32, reps: int = 2
                   ) -> dict:
    """Slots admitted with ``slot_opts`` (200-token prompts from the
    seed), then ``reps`` decode dispatches of ``n`` steps straight on the
    engine: the host clock for enqueueing each and for finishing it, ms a
    step, and the kernels a step from ``torch.profiler`` over a further
    dispatch of ``PROFILED_STEPS`` steps."""
    from torch.profiler import ProfilerActivity, profile
    g = torch.Generator().manual_seed(SEED)
    for slot, o in enumerate(slot_opts):
        engine.admit(slot, torch.randint(0, engine.cfg.vocab_size, (200,),
                                         generator=g).numpy(), o)
    engine.decode_n_launch(4).wait()
    torch.cuda.synchronize()
    enqueue, wall = [], []
    for _ in range(reps):
        t0 = time.perf_counter()
        handle = engine.decode_n_launch(n)
        enqueue.append((time.perf_counter() - t0) * 1e3 / n)
        handle.wait()
        wall.append((time.perf_counter() - t0) * 1e3 / n)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        engine.decode_n_launch(PROFILED_STEPS).wait()
    cuda = getattr(torch.autograd.DeviceType, "CUDA", None)
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == cuda]
    for slot in range(len(slot_opts)):
        engine.release(slot)
    return {"host_enqueue_ms_per_step": enqueue, "wall_ms_per_step": wall,
            "kernel_launches_per_step": (
                sum(e.count for e in kernels) / PROFILED_STEPS
                if kernels else "not measured")}


def sampling_costs(torch, pkg, label: str) -> dict:
    """llama3.2:3b (path 9's model's widths and depth) from the seed in
    int8 on its paged serving defaults, built by the port package ``pkg``
    (this checkout's, or ``baseline_port``); its scheduler stopped, one
    dispatch of 8 slots greedy, 8 sampled at temperature 0.8 (Ollama's
    defaults: top_k 40, top_p 0.9, repeat penalty 1.1), and 8 sampled
    with slot 0 under mirostat 2 (:func:`dispatch_steps`)."""
    import gc
    import importlib
    app = importlib.import_module(f"{pkg}.server.app")
    eng = importlib.import_module(f"{pkg}.runtime.engine")
    cfg = importlib.import_module(f"{pkg}.models.config").get_config(
        GGUF_MODEL)
    t0 = time.perf_counter()
    mm = app.ModelManager()
    lm = mm.preload(GGUF_MODEL, cfg, dense_params(torch, cfg),
                    byte_tokenizer(cfg.vocab_size), template="{{ .Prompt }}")
    mm.shutdown()
    torch.cuda.synchronize()
    out = {"package": label, "serving_dtype": lm.serving_dtype,
           "build_s": time.perf_counter() - t0}
    SO = eng.SlotOptions
    modes = {"greedy": [SO(temperature=0)] * 8,
             "sampled": [SO(temperature=0.8, seed=s) for s in range(8)],
             "sampled_one_mirostat": [SO(temperature=0.8, seed=0,
                                         mirostat=2)]
             + [SO(temperature=0.8, seed=s) for s in range(1, 8)]}
    for mode, opts in modes.items():
        out[mode] = dispatch_steps(torch, lm.engine, opts)
        print(f"host costs, {label}: {GGUF_MODEL} {lm.serving_dtype}, 8 "
              f"slots {mode}: {out[mode]}", flush=True)
    del lm, mm
    gc.collect()
    torch.cuda.empty_cache()
    return out


def image_contention(torch, details, card: str, base_images) -> dict:
    """llava as path 15 (a) serves it (full width and depth, int4, the
    CLIP ViT-L/14-336 tower from an mmproj written from the seed) behind
    the HTTP server: the host's decode + resize of one 1024×768 PNG by
    this checkout's ``server/images.py`` and by ``base_images`` (a
    baseline commit's), then rounds of 4 greedy text-only /api/generate
    streams of 64 tokens, their ms a token (``eval_duration`` over
    ``eval_count``): alone; beside a thread of this process decoding and
    resizing that PNG over and over with this checkout's code, then with
    the baseline's (the work an HTTP thread does for each uploaded image,
    under the same interpreter lock as the scheduler); beside 4 real
    image requests (one token each) sent 0.5 s apart, the server's PNG
    decoder this checkout's, then the baseline's; alone again."""
    import base64
    import gc
    from unittest import mock

    from ollama_operator_tpu_torch.convert import params_from_numpy
    from ollama_operator_tpu_torch.gguf.reader import GGUFFile
    from ollama_operator_tpu_torch.gguf.transcode import (
        load_vision_params, vision_config_from_gguf)
    from ollama_operator_tpu_torch.models import vision as V
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.runtime.engine import resolve_engine_dtype
    from ollama_operator_tpu_torch.server import images as I
    from ollama_operator_tpu_torch.server.app import ModelManager, serve
    cfg = get_config("llava")
    workdir = tempfile.mkdtemp(prefix="chip_smoke_contention_")
    out = {"model": "llava", "card": card}
    png = seeded_png(768, 1024, 2, SEED + 3)
    b64 = base64.b64encode(png).decode()
    for label, mod in (("this", I), ("baseline", base_images),
                       ("this", I), ("baseline", base_images)):
        t0 = time.perf_counter()
        img = mod.decode_image(png)
        t1 = time.perf_counter()
        mod.preprocess(img, 336)
        t2 = time.perf_counter()
        out.setdefault("host_ms_1024x768", []).append(
            {"code": label, "decode_ms": (t1 - t0) * 1e3,
             "resize_ms": (t2 - t1) * 1e3})
    try:
        g = write_mmproj(torch, os.path.join(workdir, "mmproj.gguf"),
                         V.VisionConfig(**CLIP_L14_336))
        with GGUFFile(g["path"]) as f:
            vcfg = vision_config_from_gguf(f)
            vparams = params_from_numpy(
                load_vision_params(f, vcfg, "bfloat16"), "cuda")
        mm = ModelManager()
        mm.preload("llava", cfg, dense_params(torch, cfg),
                   byte_tokenizer(cfg.vocab_size, bos=LLAVA_BOS),
                   dtype=resolve_engine_dtype(cfg, "cuda"),
                   template=LLAVA_TEMPLATE, vision=(vcfg, vparams))
        httpd = serve(mm, "127.0.0.1", 0)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    port = httpd.server_address[1]
    opts = {"temperature": 0, "num_predict": 64, "repeat_penalty": 1.0}
    prompts = [f"tell me about the number {i} and what it means"
               for i in range(4)]

    def decoding(mod):
        def run(stop, done):
            while not stop.is_set():
                mod.preprocess(mod.decode_image(b64), vcfg.image_size)
                done.append(1)
        return run

    def uploads(stop, done):
        def one():
            http(port, "/api/generate", {
                "model": "llava", "prompt": "what is in this picture",
                "images": [b64], "options": dict(opts, num_predict=1)})
            done.append(1)
        threads = []
        for _ in range(4):
            threads.append(threading.Thread(target=one))
            threads[-1].start()
            time.sleep(0.5)
        for t in threads:
            t.join(timeout=600)

    # (name, side work, the PNG decoder the server runs)
    rounds = (("alone", None, None), ("decoding_this", decoding(I), None),
              ("decoding_baseline", decoding(base_images), None),
              ("image_requests", uploads, None),
              ("image_requests_baseline_decoder", uploads,
               base_images.decode_png),
              ("alone_again", None, None))
    try:
        http(port, "/api/generate", {"model": "llava", "prompt": "warm up",
                                     "images": [b64], "options": dict(
                                         opts, num_predict=2)})
        for name, side, decoder in rounds:
            stop, done = threading.Event(), []
            th = (threading.Thread(target=side, args=(stop, done))
                  if side else None)
            with mock.patch.object(I, "decode_png",
                                   decoder or I.decode_png):
                if th:
                    th.start()
                results, wall = concurrent([
                    lambda p=p: http(port, "/api/generate", {
                        "model": "llava", "prompt": p, "options": opts})
                    for p in prompts])
                stop.set()
                if th:
                    th.join(timeout=600)
            finals = [frames[-1] for _, frames, _ in results]
            if any(f.get("eval_count") != 64 for f in finals):
                raise RuntimeError(f"contention round {name}: {finals}")
            ms = [f["eval_duration"] / 1e6 / f["eval_count"]
                  for f in finals]
            out[name] = {"ms_per_token": ms, "wall_s": wall,
                         "side_work_done": len(done)}
            print(f"image contention [{card}] {name}: text ms a token "
                  f"{[round(x, 2) for x in ms]}, wall {wall:.3f} s, side "
                  f"work done {len(done)}", flush=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()
    print(f"host decode + resize of a 1024x768 PNG: "
          f"{out['host_ms_1024x768']}", flush=True)
    del mm, vparams
    gc.collect()
    torch.cuda.empty_cache()
    return out


def host_costs(torch, details, card: str, baseline_root: str):
    """``--host-costs --baseline DIR``: the host's share of a decode step
    that sampling and image uploads add, this checkout beside the
    baseline commit at DIR, in the order baseline, this, this, baseline
    (:func:`sampling_costs`), then :func:`image_contention`."""
    import importlib
    from ollama_operator_tpu_torch.ops import cuda_build
    base = load_baseline(baseline_root)
    # the same sources give the same library names: no second build
    importlib.import_module("baseline_port.ops.cuda_build").BUILD_DIR = (
        cuda_build.BUILD_DIR)
    runs = [sampling_costs(torch, pkg, label) for pkg, label in (
        ("baseline_port", "baseline"),
        ("ollama_operator_tpu_torch", "this"),
        ("ollama_operator_tpu_torch", "this"),
        ("baseline_port", "baseline"))]
    details["host_costs"] = {"sampling": runs, "images": image_contention(
        torch, details, card,
        importlib.import_module("baseline_port.server.images"))}
    del base


DRIFT_DEPTHS = (2, 6, 12, 34)


def drift_sweep(torch, details):
    """gemma3 at full width, int8 weights, an int8 pool, at each depth of
    ``DRIFT_DEPTHS`` (the first layers of one 34-layer draw): a
    1500-token prompt and 16 greedy steps on the kernel path, then the
    plain path and the control teacher-forced on its tokens. The control
    is the plain path with each int8 product summed over two halves of K
    in f32: the same function, rounded at the same points, its sums in
    another order. Prints the largest logit difference of kernel against
    plain and of plain against control at each depth; decides nothing."""
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import quant as Q
    cfg = get_config("gemma3")
    params = Q.quantize_params(dense_params(torch, cfg), bits=8)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    ids = torch.randint(0, cfg.vocab_size, (GEMMA3_LONG,),
                        generator=gen).tolist()
    saved, rows = Q.matmul, []
    for depth in DRIFT_DEPTHS:
        c = dataclasses.replace(cfg, n_layers=depth)
        p = dict(params, layers={
            k: ({kk: vv[:depth] for kk, vv in v.items()}
                if isinstance(v, dict) else v[:depth])
            for k, v in params["layers"].items()})
        lk, sk = teacher_forced(torch, c, p, ids, 16, "int8")
        got = []
        for split in (1, 2):
            Q.matmul = functools.partial(plain_matmul, split=split)
            try:
                got.append(teacher_forced(torch, c, p, ids, 16, "int8",
                                          teacher=sk))
            finally:
                Q.matmul = saved
        (lp, sp), (lc, _) = got
        row = {"layers": depth,
               "kernel_vs_plain": (lk - lp).abs().max().item(),
               "plain_vs_control": (lp - lc).abs().max().item(),
               "logit_scale": lp.abs().max().item(),
               "tokens_equal": sum(a == b for a, b in zip(sk, sp))}
        rows.append(row)
        print(f"drift gemma3 int8, {depth} layers: logits max |kernel - "
              f"plain| {row['kernel_vs_plain']:.4g}, |plain - control| "
              f"{row['plain_vs_control']:.4g} (max |logit| "
              f"{row['logit_scale']:.4g}); kernel and plain tokens equal "
              f"at {row['tokens_equal']}/17 steps", flush=True)
    details["drift"] = rows
    del params
    torch.cuda.empty_cache()


def _final(stream):
    final = None
    for _piece, res in stream:
        final = res or final
    return final


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json and ptxas.txt")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
    ap.add_argument("--baseline", default=None, metavar="DIR",
                    help="a checkout of another commit: also time its "
                         "paged-decode (K6, K4, K5), flash-prefill (K1) "
                         "and dense-decode (K2, K3) wrappers at their rows, "
                         "and fail unless each gives the same bits where "
                         "that commit takes the shape")
    ap.add_argument("--families-only", action="store_true",
                    help="build the kernels, then run path 12 (gemma3 at "
                         "12 layers) and the other families' cross-checks "
                         "alone; no result line")
    ap.add_argument("--drift", action="store_true",
                    help="build the kernels, then print gemma3's logit "
                         "differences, kernel against plain and plain "
                         "against another order of its sums, at 2, 6, 12 "
                         "and 34 layers; no result line")
    ap.add_argument("--moe-only", action="store_true",
                    help="build the kernels, then time one MoE layer and "
                         "run the mixture-of-experts cross-checks and path "
                         "13 (qwen3moe at full depth) alone; no result line")
    ap.add_argument("--embed-only", action="store_true",
                    help="build the kernels, then run path 14 (decoder "
                         "embeddings on a created llama3.2:3b, the "
                         "embedding cross-checks and kernel rows, the "
                         "mxbai-embed-large encoder, one embed on a "
                         "4-layer qwen3moe) alone; no result line")
    ap.add_argument("--vision-only", action="store_true",
                    help="build the kernels, then run path 15 alone: llava "
                         "with images at full depth, then mirostat and an "
                         "adapter on a created llama3.2:3b; no result line")
    ap.add_argument("--host-costs", action="store_true",
                    help="with --baseline DIR: build the kernels, then time "
                         "a decode dispatch of llama3.2:3b greedy, sampled "
                         "and with a mirostat slot, this checkout beside "
                         "DIR's, and llava's text streams beside image "
                         "decoding and image requests; no result line")
    ap.add_argument("--gguf-only", action="store_true",
                    help="build the kernels, then run paths 9, 10 and 11 "
                         "(the pulled GGUF model, its chat and structured "
                         "output, its lifecycle) alone; no result line")
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
    try:
        import PIL
        pillow = f"imports (Pillow {PIL.__version__})"
    except ImportError:
        pillow = "does not import"
    details["pillow"] = pillow
    print(f"Pillow on this host: {pillow} (PNG images decode without it; "
          f"other formats need it)", flush=True)
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

    def lap(phase: str):
        """The time since the build started, printed and recorded."""
        took = time.perf_counter() - t0
        details.setdefault("elapsed_s", {})[phase] = took
        print(f"elapsed {took:.1f} s (after {phase})", flush=True)

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

    report.rows = rows

    if args.families_only:
        try:
            gemma3_phase(torch, details)
            family_cross_checks(torch, details)
        except Exception as e:  # noqa: BLE001 — the phase's failure
            import traceback
            traceback.print_exc()
            return fail(f"path 12 and the family cross-checks: {e!r}")
        write_details(out_dir, details)
        print("families-only run (path 12, the family cross-checks): no "
              "kernel rows; no result", flush=True)
        return 4
    if args.moe_only:
        try:
            moe_layer_times(torch, Timer(torch), details)
            family_cross_checks(torch, details, MOE_FAMILIES)
            moe_phase(torch, details)
        except Exception as e:  # noqa: BLE001 — the phase's failure
            import traceback
            traceback.print_exc()
            return fail(f"the MoE checks and path 13: {e!r}")
        write_details(out_dir, details)
        print("moe-only run (the MoE layer, the MoE cross-checks, path 13): "
              "no kernel rows; no result", flush=True)
        return 4
    if args.drift:
        try:
            drift_sweep(torch, details)
        except Exception as e:  # noqa: BLE001 — the sweep's failure
            import traceback
            traceback.print_exc()
            return fail(f"drift sweep: {e!r}")
        write_details(out_dir, details)
        print("drift run: no kernel rows; no result", flush=True)
        return 4
    if args.gguf_only:
        workdir = tempfile.mkdtemp(prefix="chip_smoke_gguf_")
        try:
            _, _, _, tokenizer, _ = gguf_phase(torch, details, card,
                                               workdir)
            grammar_cross_check(torch, details, card, tokenizer)
            replay_cross_check(torch, details, card, tokenizer)
        except Exception as e:  # noqa: BLE001 — the phase's failure
            import traceback
            traceback.print_exc()
            return fail(f"paths 9, 10 and 11: {e!r}")
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        write_details(out_dir, details)
        print("gguf-only run (paths 9, 10 and 11): no kernel rows; no "
              "result",
              flush=True)
        return 4
    if args.host_costs:
        if not args.baseline:
            return fail("--host-costs needs --baseline DIR")
        try:
            host_costs(torch, details, card, args.baseline)
        except Exception as e:  # noqa: BLE001 — the phase's failure
            import traceback
            traceback.print_exc()
            return fail(f"host costs: {e!r}")
        write_details(out_dir, details)
        print("host-costs run: no result", flush=True)
        return 4
    if args.vision_only:
        try:
            vision_only(torch, details, card)
        except Exception as e:  # noqa: BLE001 — the phase's failure
            import traceback
            traceback.print_exc()
            return fail(f"path 15: {e!r}")
        write_details(out_dir, details)
        print("vision-only run (path 15): no result", flush=True)
        return 4
    if args.embed_only:
        try:
            embed_only(torch, details, card, Timer(torch), report)
        except Exception as e:  # noqa: BLE001 — the phase's failure
            import traceback
            traceback.print_exc()
            return fail(f"path 14: {e!r}")
        write_details(out_dir, details)
        print("embed-only run (path 14): no result", flush=True)
        return 4
    try:
        timer = Timer(torch)
        baseline = (load_baseline_paged(args.baseline) if args.baseline
                    else None)
        kernel_phases(torch, timer, report, baseline)
        moe_layer_times(torch, timer, details)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — every phase failure is fatal
        import traceback
        traceback.print_exc()
        return fail(f"kernel phase: {e!r}")
    details["kernel_rows"] = rows
    lap("kernels")
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
            lap(f"path {i + 1}")
        # 5. prefix reuse and chunked prefill on path 1, then its decode
        # step and its teardown
        try:
            prefix_phase(torch, details, kept[3])
        finally:
            close_serving(torch, details, *kept, grammar=True)
            kept = None
        lap("prefix phase (5)")
        prefix_cross_check(torch, details, "llama3.1", 4, "int8", 1000,
                           exact_gate=True)
        prefix_cross_check(torch, details, "llama3.2:3b", 8, "int4", 1001,
                           exact_gate=False)
        prefix_cross_check(torch, details, "llama3.1", 4, "bfloat16", 1000,
                           exact_gate=True)
        lap("prefix cross-checks (6)")
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
        lap("cross-checks (4)")
        # 7. path 9: the pulled GGUF model, served by the port's processes,
        # and path 10 on the same server
        workdir = tempfile.mkdtemp(prefix="chip_smoke_gguf_")
        try:
            (launches_by_path[GGUF_PATH], launches_by_path[CHAT_PATH],
             launches_by_path[LIFE_PATH], tokenizer,
             launches_by_path[EMBED_PATH]) = gguf_phase(torch, details, card,
                                                        workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        lap("paths 9-11")
        # path 14 (b) and the kernel rows at its shapes ((a) and (c) ran
        # on path 9's server above, (d) runs on path 13's model below)
        embed_checks(torch, details, timer, report)
        lap("path 14 (b) and its kernel rows")
        # 8. path 10's grammar cross-check in this process
        grammar_cross_check(torch, details, card, tokenizer)
        lap("grammar cross-check")
        # 9. path 11's replay cross-check in this process
        replay_cross_check(torch, details, card, tokenizer)
        lap("replay cross-check")
        # 10. path 12: gemma3 at full width and depth, then the other
        # dense families' two-layer cross-checks
        launches_by_path[GEMMA3_PATH] = gemma3_phase(torch, details)
        lap("path 12")
        family_cross_checks(torch, details)
        lap("family cross-checks")
        # 11. path 13: qwen3moe at full width and depth (61 GB of bf16
        # weights: every earlier path has released the card)
        launches_by_path[MOE_PATH] = moe_phase(torch, details)
        launches_by_path[EMBED_MOE_PATH] = details["embed_path"]["d"][
            "launches"]
        lap("path 13")
        embed_total(details)
        # 12. path 15 (a): llava with images at full width and depth ((b)
        # and (c) ran on path 9's server above)
        workdir = tempfile.mkdtemp(prefix="chip_smoke_llava_")
        try:
            launches_by_path[LLAVA_PATH] = llava_phase(torch, details, card,
                                                       workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
        p15 = details["path15"]["server"]
        launches_by_path[MIROSTAT_PATH] = p15["mirostat"]["launches"]
        launches_by_path[ADAPTER_PATH] = p15["adapter"]["launches"]
        lap("path 15 (a)")
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
