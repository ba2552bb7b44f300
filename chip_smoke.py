#!/usr/bin/env python3
"""Drive the torch port (``ollama_operator_tpu_torch``) on one NVIDIA H100.

Run from the repository root:  python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. Print the card (``nvidia-smi`` name and power limit), the torch and
   CUDA versions, and build the three CUDA kernels from ``csrc/`` (one
   ``nvcc`` per source, all started together).
2. Kernel phases at the main path's shapes, in bf16 on the card: each
   kernel against its plain PyTorch version on the same inputs, with the
   tolerance stated beside it; the kernel's time (CUDA events, L2 flushed
   before every launch, as a decode step finds it), the plain version's
   time, the time of one PyTorch library call computing the same function
   where one exists, and the least time the card could take (bytes at
   3.35 TB/s or bf16 operations at 989 TFLOP/s, whichever is larger).
3. Serving: llama3.1 at full width (32 layers, dim 4096, 32/8 heads,
   vocab 128256), random int4 group-32 weights from a seed, the int8 paged
   KV pool, the serving defaults (64 slots, page size 128, 768 pages,
   decode chunk 32), behind the port's HTTP server on an ephemeral port.
   Eight concurrent /api/generate requests (prompts of at most 256
   tokens, num_predict 32, greedy) must each finish with eval_count 32, a
   repeat of one prompt must give the same tokens, and every kernel's
   launch count over this phase must be above 0.
4. Cross-check at full width and two layers: the kernel path against the
   plain path on the card, a prefill and 16 greedy decode steps, the plain
   path fed the kernel path's tokens. Logits must agree within the stated
   bf16 tolerance at every step, and the greedy tokens must be identical
   at every step where greedy is decidable (top-2 gap above twice the
   step's logit difference; near-ties are listed).

Then it prints one JSON line ``{"kernels": [...]}``, the ``nvidia-smi``
line, and as the last line ``{"ok": true, "device": {...}}``. With
``--out DIR`` the details (``chip_smoke.json``) and the compiler's
register report (``ptxas.txt``) are written to DIR; ``--kernels-only``
stops after phase 2.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
BF16_FLOPS = 989e12            # H100 SXM dense bf16 tensor-core peak
SEED = 20261017


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
    L2 flush (a 256 MB write), so weights and pages come from HBM."""

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
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            fn()
            e.record()
            e.synchronize()
            total += s.elapsed_time(e)
        return total / iters


def kernel_phases(torch, timer, report):
    import torch.nn.functional as F
    from ollama_operator_tpu_torch.ops import attention as A
    from ollama_operator_tpu_torch.ops import paged as PG
    from ollama_operator_tpu_torch.ops import quant as Q
    g = torch.Generator(device="cuda").manual_seed(SEED)
    dev, bf = "cuda", torch.bfloat16

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    # -- flash prefill: B=1, T=512, H=32, KvH=8, hd=128 (llama3.1 chunk)
    B, T, H, KvH, hd = 1, 512, 32, 8, 128
    q, k, v = randn(B, T, H, hd), randn(B, KvH, T, hd), randn(B, KvH, T, hd)
    scale = hd ** -0.5
    out = A.flash_prefill(q, k, v, scale)
    ref = A.flash_prefill_plain(q, k, v, scale)
    err = (out.float() - ref.float()).abs().max().item()
    # both round an f32 result to bf16; 1 bf16 ulp is at most 2^-7
    # (0.8%) of the value, so 1% of the largest output covers it
    tol = 1e-2 * max(1.0, ref.float().abs().max().item())
    qh = q.transpose(1, 2)
    kr = k.repeat_interleave(H // KvH, dim=1)
    vr = v.repeat_interleave(H // KvH, dim=1)
    nbytes = 2 * (2 * q.numel() + k.numel() + v.numel())
    flops = 4 * H * hd * T * (T + 1) / 2
    report("flash_prefill", "csrc/flash_prefill.cu",
           "ollama_operator_tpu/ops/pallas/flash.py:134", err, tol,
           timer(lambda: A.flash_prefill(q, k, v, scale)),
           timer(lambda: A.flash_prefill_plain(q, k, v, scale)),
           timer(lambda: F.scaled_dot_product_attention(
               qh, kr, vr, is_causal=True, scale=scale)),
           *bound(nbytes, flops), shape=f"B={B} T={T} H={H} KvH={KvH} "
                                         f"hd={hd}")

    # -- paged decode: B=64, ps=128, int8 pool, lengths over 1..2048
    B, ps, L, NBLK = 64, 128, 2, 32
    lengths = torch.randint(1, 2049, (B,), generator=g, device=dev,
                            dtype=torch.int32)
    live = (lengths.long() // ps + 1)
    P = int(live.sum().item()) + 1
    perm = torch.randperm(P - 1, generator=g, device=dev).int() + 1
    tables = torch.zeros((B, NBLK), dtype=torch.int32, device=dev)
    off = 0
    for b in range(B):
        n = int(live[b])
        tables[b, :n] = perm[off:off + n]
        off += n

    def pool():
        return {"q": torch.randint(-127, 128, (L, P, KvH, ps, hd),
                                   generator=g, device=dev,
                                   dtype=torch.int8),
                "s": torch.rand((L, P, KvH, ps), generator=g,
                                device=dev) * 0.02 + 1e-3}
    kp, vp = pool(), pool()
    qd = randn(B, 1, H, hd)
    nblk = int(live.max().item())
    args = (qd, kp, vp, 1, tables, lengths, scale)
    out = PG.paged_decode_attention(*args, nblk=NBLK)
    ref = PG.paged_decode_attention_plain(*args, nblk=nblk)
    err = (out.float() - ref.float()).abs().max().item()
    tol = 1e-2 * max(1.0, ref.float().abs().max().item())
    n_pos = int((lengths.long() + 1).sum().item())
    nbytes = (2 * 2 * qd.numel() + 2 * KvH * n_pos * (hd + 4)
              + 4 * B * NBLK + 4 * B)
    flops = 4 * H * hd * n_pos
    report("paged_decode_attention", "csrc/paged_decode.cu",
           "ollama_operator_tpu/ops/pallas/paged.py:609", err, tol,
           timer(lambda: PG.paged_decode_attention(*args, nblk=NBLK)),
           timer(lambda: PG.paged_decode_attention_plain(*args, nblk=nblk)),
           None, *bound(nbytes, flops),
           shape=f"B={B} H={H} KvH={KvH} hd={hd} ps={ps} int8, lengths "
                 f"1..2048 ({n_pos} positions)")
    del kp, vp

    # -- qmm4 on every llama3.1 projection shape, N in {1, 64, 512}
    shapes = {"wq/wo": (4096, 4096), "wk/wv": (4096, 1024),
              "w_gate/w_up": (4096, 14336), "w_down": (14336, 4096),
              "lm_head": (4096, 128256)}
    for wname, (K, O) in shapes.items():
        qw = Q.quantize_groupwise_int4(
            torch.randn((K, O), generator=g, device=dev) * 0.02)
        wbf = Q.dequantize_groupwise(qw).to(bf)
        for N in (1, 64, 512):
            x = randn(N, K)
            out = Q.qmm4(x, qw["q4"], qw["s"])
            ref = Q.qmm4_plain(x, qw["q4"], qw["s"])
            err = (out - ref).abs().max().item()
            qtol = 1e-3   # f32 sums of the same products, other order
            nbytes = 2 * N * K + K * O // 2 + 4 * (K // 32) * O + 4 * N * O
            report("qmm4", "csrc/qmm4.cu",
                   "ollama_operator_tpu/ops/pallas/quant.py:142", err, qtol,
                   timer(lambda: Q.qmm4(x, qw["q4"], qw["s"])),
                   timer(lambda: Q.qmm4_plain(x, qw["q4"], qw["s"])),
                   timer(lambda: torch.matmul(x, wbf)),
                   *bound(nbytes, 2.0 * N * K * O),
                   shape=f"{wname} N={N} K={K} O={O}",
                   main=(wname == "w_gate/w_up" and N == 64))
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


def build_model(torch, cfg):
    from ollama_operator_tpu_torch.models import decoder
    from ollama_operator_tpu_torch.ops import quant as Q
    g = torch.Generator(device="cuda").manual_seed(SEED)
    params = decoder.init_params(cfg, g, torch.bfloat16, "cuda")
    params = Q.quantize_params(params, bits=4)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
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


def serving_phase(torch, details) -> dict:
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import cuda_build
    from ollama_operator_tpu_torch.server.app import ModelManager, serve
    cfg = get_config("llama3.1")
    t0 = time.perf_counter()
    params = build_model(torch, cfg)
    t_build = time.perf_counter() - t0
    mm = ModelManager()            # the card: no device argument
    lm = mm.preload("llama3.1", cfg, params, byte_tokenizer(cfg.vocab_size),
                    template="{{ .Prompt }}")
    del params
    e = lm.ecfg
    print(f"serving config: slots={e.max_slots} page_size={e.page_size} "
          f"pages={e.n_pages} max_seq={e.max_seq_len} "
          f"chunk={e.decode_chunk} kv={e.cache_dtype} "
          f"kv_bytes={lm.engine.kv_bytes / 1e9:.2f}GB "
          f"mem_allocated={torch.cuda.memory_allocated() / 1e9:.2f}GB "
          f"build_s={t_build:.1f}", flush=True)
    httpd = serve(mm, "127.0.0.1", 0)
    port = httpd.server_address[1]
    try:
        words = ("paged attention over int4 weights on one card "
                 "serves many slots at once").split()
        prompts = [" ".join(words[(i + j) % len(words)]
                            for j in range(12 + 4 * i))[:240]
                   for i in range(8)]
        opts = {"temperature": 0, "num_predict": 32}
        post(port, {"model": "llama3.1", "prompt": "warm up",
                    "stream": False, "options": opts})
        for name in cuda_build.launches:
            cuda_build.launches[name] = 0
        results = [None] * len(prompts)
        errors = []

        def run(i):
            try:
                results[i] = post(port, {"model": "llama3.1",
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
        rep = post(port, {"model": "llama3.1", "prompt": prompts[3],
                          "stream": False, "options": opts})
        if rep["context"] != results[3]["context"]:
            raise RuntimeError("a repeated greedy prompt gave other tokens")
        missing = [k for k, n in launches.items() if n <= 0]
        if missing:
            raise RuntimeError(f"kernels not launched while serving: "
                               f"{missing} ({launches})")
        n_tok = sum(r["eval_count"] for r in results)
        ttft = sorted(r["prompt_eval_duration"] / 1e6 for r in results)
        out = {"requests": len(results), "wall_s": wall,
               "generated_tokens": n_tok, "aggregate_tok_s": n_tok / wall,
               "ttft_ms": ttft,
               "prompt_tokens": [r["prompt_eval_count"] for r in results],
               "launches": launches}
        print(f"serving: {len(results)} requests x 32 tokens in "
              f"{wall:.3f} s: {n_tok / wall:.1f} tok/s aggregate; TTFT ms "
              f"min {ttft[0]:.1f} median {ttft[len(ttft) // 2]:.1f} max "
              f"{ttft[-1]:.1f}; launches {launches}", flush=True)
        details["serving"] = out
        return launches
    finally:
        httpd.shutdown()
        httpd.server_close()
        mm.shutdown()
        torch.cuda.empty_cache()


def cross_check(torch, details):
    """Two layers at full width: kernel path vs plain path on the card."""
    from ollama_operator_tpu_torch.models import decoder
    from ollama_operator_tpu_torch.models.config import get_config
    from ollama_operator_tpu_torch.ops import attention as A
    from ollama_operator_tpu_torch.ops import paged as PG
    from ollama_operator_tpu_torch.ops import quant as Q
    cfg = dataclasses.replace(get_config("llama3.1"), n_layers=2)
    params = build_model(torch, cfg)
    dev = "cuda"

    def plain_matmul(x, w, out_dtype=None):
        if not Q.is_quantized(w):
            y = x @ w
            return y.to(out_dtype) if out_dtype is not None else y
        y = Q.qmm4_plain(x.reshape(-1, x.shape[-1]), w["q4"], w["s"])
        return y.reshape(*x.shape[:-1], -1).to(out_dtype or x.dtype)

    def plain_chunk(cfg, q, k, v, scale):
        return A.flash_prefill_plain(q, k, v, scale, cfg.attn_softcap,
                                     cfg.sliding_window)

    plain_fns = {"qmm4": (Q, "matmul", plain_matmul),
                 "flash_prefill": (decoder, "chunk_attention", plain_chunk),
                 "paged_decode": (decoder, "paged_decode_attention",
                                  PG.paged_decode_attention_plain)}

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
            shp = (L, 8, KvH, ps, hd)
            kp = {"q": torch.zeros(shp, dtype=torch.int8, device=dev),
                  "s": torch.zeros(shp[:-1], device=dev)}
            vp = {"q": torch.zeros(shp, dtype=torch.int8, device=dev),
                  "s": torch.zeros(shp[:-1], device=dev)}
            n, bucket = 200, 256
            toks = torch.zeros((1, bucket), dtype=torch.long, device=dev)
            gen = torch.Generator(device="cpu").manual_seed(SEED)
            toks[0, :n] = torch.randint(0, cfg.vocab_size, (n,),
                                        generator=gen).to(dev)
            table = torch.zeros((1, NBLK), dtype=torch.int32, device=dev)
            table[0, :3] = torch.tensor([4, 1, 6], dtype=torch.int32)
            logits, ks, vs = decoder.prefill_chunk(params, cfg, toks)
            decoder.paged_insert(cfg, kp, vp, ks, vs, table[0], n)
            out = [logits[0, n - 1]]
            lengths = torch.tensor([n], dtype=torch.int32, device=dev)
            for step in range(16):
                tok = (out[-1].argmax() if teacher is None
                       else torch.tensor(teacher[step], device=dev))
                lg, _, _ = decoder.forward_with_cache_paged(
                    params, cfg, tok.view(1, 1), kp, vp, table, lengths, 3)
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
    details["cross_check"] = {"logit_max_abs_err": err, "logit_scale": scale,
                              "tol": tol, "step_err": step_err,
                              "plain_top2_gap": gaps, "near_tie_steps": ties,
                              "kernel_tokens": sk, "plain_tokens": sp}
    print(f"cross-check (2 layers, full width, 17 steps): logits max |err| "
          f"{err:.4g} (tol {tol:.4g}, max |logit| {scale:.4g}); per step "
          f"{[round(e, 4) for e in step_err]}; tokens equal at "
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
        raise RuntimeError(f"kernel and plain paths disagree: decidable "
                           f"tokens differ at steps {bad}, logits {err} vs "
                           f"tol {tol}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default=None,
                    help="directory for chip_smoke.json and ptxas.txt")
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after building and checking the kernels")
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

    rows, entries = [], {}

    def report(name, source, replaces, err, tol, ms, plain_ms, library_ms,
               bound_ms, bound_by, shape="", main=True):
        ok = err <= tol
        row = dict(name=name, shape=shape, max_abs_err=err, tol=tol, ms=ms,
                   plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, ok=ok)
        rows.append(row)
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"kernel {name} [{shape}]: max|err| {err:.3g} (tol {tol:g}) "
              f"{'ok' if ok else 'FAIL'}; ms {ms:.4f} plain {plain_ms:.4f} "
              f"library {lib} bound {bound_ms:.4f} ({bound_by})", flush=True)
        e = entries.setdefault(name, dict(
            name=name, route="cuda", source="ollama_operator_tpu_torch/"
            + source, replaces=replaces, max_abs_err=0.0))
        e["max_abs_err"] = max(e["max_abs_err"], err)
        e["ok"] = e.get("ok", True) and ok
        if main:
            e.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                     bound_by=bound_by, library_ms=library_ms, shape=shape)

    try:
        timer = Timer(torch)
        kernel_phases(torch, timer, report)
        torch.cuda.synchronize()
    except Exception as e:  # noqa: BLE001 — every phase failure is fatal
        import traceback
        traceback.print_exc()
        return fail(f"kernel phase: {e!r}")
    details["kernel_rows"] = rows
    bad = [r for r in rows if not r["ok"]]
    if bad:
        return fail(f"kernels disagree with their plain versions: {bad}")
    if args.kernels_only:
        write_details(out_dir, details)
        print("kernels-only run: no serving phase; no result", flush=True)
        return 4

    try:
        launches = serving_phase(torch, details)
        cross_check(torch, details)
    except Exception as e:  # noqa: BLE001 — every phase failure is fatal
        import traceback
        traceback.print_exc()
        return fail(repr(e))
    names = {"flash_prefill": "flash_prefill",
             "paged_decode_attention": "paged_decode",
             "qmm4": "qmm4"}
    kernels = []
    for name, e in entries.items():
        e.pop("ok", None)
        e["launches"] = launches[names[name]]
        kernels.append({k: e[k] for k in (
            "name", "route", "source", "replaces", "launches",
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "shape")})
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
