"""CLI entry: `python -m ollama_operator_tpu_torch.server`.

The port's counterpart of ``python -m ollama_operator_tpu.server``, with
the same flags and environment knobs. It runs either role of a deployment:

- model server (a model's pods): ``--preload <model>`` loads the model from
  the blob store at startup (GGUF read, dequantized, transcoded through the
  ``--cache`` directory) and serves it on ``--device`` (``cuda``, the
  default, raises without CUDA; ``cpu`` runs on the CPU);
- store server (the store's pods): ``--store-only`` serves ``/api/pull``
  into the shared store and the model-management routes; it builds no
  engine and touches no device.

Typical start, from a checkout::

    python -m ollama_operator_tpu_torch.server --store-only --store S --port 11435
    OLLAMA_HOST=127.0.0.1:11435 python -m ollama_operator_tpu_torch.server.pull <model>
    python -m ollama_operator_tpu_torch.server --store S --cache C --preload <model>

Tensor, sequence, expert and data parallelism (``--tp``/``--sp``/``--ep``/
``--dp`` above 1) and multi-host worlds (``TPU_DIST_HOSTS`` above 1) are
refused until the port has them.

SIGTERM (or SIGINT) shuts the server down as the reference's does, every
step bounded so that a wedged engine never turns a rollout's SIGTERM into
a SIGKILL: drain (``/readyz`` answers 503 "draining", new work is shed
with 503 + Retry-After, running streams finish within
``TPU_DRAIN_TIMEOUT_S``, 30 s by default, stragglers get a terminal
``"drain"`` frame), wait for the handlers to write their last frames,
stop the listener, unload the models and stop the keep-alive reaper,
then dump the flight recorder to stderr.
"""

from __future__ import annotations

import argparse
import os
import signal
import sys
import time


def main(argv=None):
    p = argparse.ArgumentParser("torch-ollama-server")
    p.add_argument("--host", default=os.environ.get("OLLAMA_HOST_BIND",
                                                    "0.0.0.0"))
    p.add_argument("--port", type=int,
                   default=int(os.environ.get("OLLAMA_PORT", "11434")))
    p.add_argument("--store", default=os.environ.get(
        "OLLAMA_MODELS", os.path.expanduser("~/.ollama/models")),
        help="blob store root (the shared volume's mount)")
    p.add_argument("--cache", default=os.environ.get("TPU_WEIGHT_CACHE"),
                   help="transcoded-weights cache dir")
    p.add_argument("--preload", default=os.environ.get("TPU_PRELOAD_MODEL"),
                   help="model to load at startup")
    p.add_argument("--store-only", action="store_true",
                   default=os.environ.get("TPU_STORE_ONLY") == "1",
                   help="registry/store mode: no inference engine")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where models run: the card (default; refused "
                        "without CUDA) or, when asked for, the CPU")
    p.add_argument("--dtype", default=os.environ.get("TPU_ENGINE_DTYPE")
                   or None,
                   choices=["bfloat16", "bf16", "float32", "int8", "int4"],
                   help="weight dtype (default: resolved per model at load "
                        "— on the card int8 below 4e9 params, int4 above, "
                        "bf16 for MoE; float32 on the CPU)")
    p.add_argument("--kv-dtype", default=os.environ.get("TPU_KV_DTYPE")
                   or None,
                   choices=["bfloat16", "float32", "int8", "int4"],
                   help="KV cache storage (default int8 on the card, "
                        "float32 on the CPU; int4 is paged only)")
    p.add_argument("--max-slots", type=int,
                   default=int(os.environ.get("TPU_MAX_SLOTS", "0")),
                   help="continuous-batching slots (0 = per-model default)")
    p.add_argument("--decode-chunk", type=int,
                   default=int(os.environ.get("TPU_DECODE_CHUNK", "0")),
                   help="decode steps per dispatch (0 = 32 on the card, 8 "
                        "on the CPU)")
    p.add_argument("--max-seq-len", type=int,
                   default=int(os.environ.get("TPU_MAX_SEQ_LEN", "4096")))
    p.add_argument("--tp", type=int,
                   default=int(os.environ.get("TPU_TENSOR_PARALLEL", "0")),
                   help="tensor-parallel ways (the port serves 1)")
    p.add_argument("--sp", type=int,
                   default=int(os.environ.get("TPU_SEQUENCE_PARALLEL", "1")),
                   help="sequence-parallel ways (the port serves 1)")
    p.add_argument("--ep", type=int,
                   default=int(os.environ.get("TPU_EXPERT_PARALLEL", "1")),
                   help="expert-parallel ways (the port serves 1)")
    p.add_argument("--dp", type=int,
                   default=int(os.environ.get("TPU_DATA_PARALLEL", "0")),
                   help="in-engine data-parallel ways (the port serves 1)")
    _paged_env = os.environ.get("TPU_PAGED", "")
    if _paged_env not in ("", "0", "1"):
        p.error(f"TPU_PAGED={_paged_env!r}: expected 1, 0, or unset")
    p.add_argument("--paged", action="store_true",
                   default=({"1": True, "0": False}.get(_paged_env, None)),
                   help="paged KV cache (unset = per-model default: paged "
                        "on the card, dense elsewhere and for MoE; "
                        "TPU_PAGED=0 forces dense)")
    p.add_argument("--page-size", type=int,
                   default=int(os.environ.get("TPU_PAGE_SIZE", "0")),
                   help="KV pool page size in tokens (0 = 128 for GQA "
                        "paged on the card, else 64)")
    p.add_argument("--n-pages", type=int,
                   default=int(os.environ.get("TPU_N_PAGES", "0")),
                   help="KV pool pages (0 = the per-model byte ceiling)")
    args = p.parse_args(argv)

    wide = {k: v for k, v in (("tp", args.tp), ("sp", args.sp),
                              ("ep", args.ep), ("dp", args.dp)) if v > 1}
    if wide:
        p.error(f"{wide}: the torch port serves one device; tensor, "
                f"sequence, expert and data parallelism are not ported yet")
    if int(os.environ.get("TPU_DIST_HOSTS", "1") or "1") > 1:
        p.error("TPU_DIST_HOSTS > 1: the torch port has no multi-host "
                "serving yet")
    if args.decode_chunk < 0:
        p.error(f"--decode-chunk {args.decode_chunk}: expected >= 0")

    from .app import ApiError, ModelManager, serve
    from .registry import RegistryError

    if args.store_only:
        # store pods hold no accelerator: no engine, no device
        manager = ModelManager(args.store, cache_dir=args.cache,
                               serve_models=False)
    else:
        import torch

        from ..runtime.engine import (EngineConfig, resolve_cache_dtype,
                                      resolve_kv_dtype_default)
        if args.device == "cuda" and not torch.cuda.is_available():
            p.error("CUDA is not available; pass --device cpu to run on "
                    "the CPU")
        try:
            kv = (resolve_cache_dtype(args.kv_dtype, args.device)
                  if args.kv_dtype else resolve_kv_dtype_default(args.device))
        except ValueError as e:
            p.error(f"--kv-dtype {args.kv_dtype}: {e}")
        ecfg = EngineConfig(max_slots=args.max_slots,
                            max_seq_len=args.max_seq_len,
                            decode_chunk=args.decode_chunk,
                            cache_dtype=kv, paged=args.paged,
                            page_size=args.page_size,
                            n_pages=args.n_pages or None)
        engine_dtype = (None if args.dtype is None
                        else {"bf16": "bfloat16"}.get(args.dtype,
                                                      args.dtype))
        print(f"device: {args.device}"
              + (f" ({torch.cuda.get_device_name(0)})"
                 if args.device == "cuda" else ""), file=sys.stderr)
        manager = ModelManager(args.store, cache_dir=args.cache,
                               device=args.device, ecfg=ecfg,
                               engine_dtype=engine_dtype)
        if args.preload:
            print(f"preloading {args.preload}...", file=sys.stderr,
                  flush=True)
            try:
                manager.load(args.preload)
            except (ApiError, RegistryError) as e:
                manager.shutdown()
                print(f"preload of {args.preload} failed: {e}",
                      file=sys.stderr, flush=True)
                return 1
            print("preload done", file=sys.stderr, flush=True)

    httpd = serve(manager, args.host, args.port)
    print(f"listening on {args.host}:{httpd.server_address[1]}",
          file=sys.stderr, flush=True)
    # block the signals before sigwait: delivery to the default
    # disposition would otherwise race the wait and skip the shutdown
    signal.pthread_sigmask(signal.SIG_BLOCK, [signal.SIGINT, signal.SIGTERM])
    stop = signal.sigwait([signal.SIGINT, signal.SIGTERM])
    print(f"signal {stop}, shutting down", file=sys.stderr, flush=True)
    graceful_shutdown(manager, httpd)
    return 0


def graceful_shutdown(manager, httpd) -> float:
    """The SIGTERM sequence: drain (bounded by TPU_DRAIN_TIMEOUT_S), wait
    up to 10 s for the handlers' last frames, stop the listener, unload
    every model and stop the reaper, dump the flight recorder. No step's
    failure stops the next. Returns the drain's seconds."""
    from ..runtime.trace import FLIGHT
    t0 = time.monotonic()
    try:
        shed = manager.drain()
        manager.wait_idle(10.0)
        print(f"drain: {time.monotonic() - t0:.3f} s, {shed} straggler(s) "
              f"ended", file=sys.stderr, flush=True)
    except Exception as e:  # noqa: BLE001 — the shutdown goes on
        print(f"drain failed: {e!r}", file=sys.stderr, flush=True)
    took = time.monotonic() - t0
    httpd.shutdown()
    httpd.server_close()
    try:
        manager.shutdown()
    except Exception as e:  # noqa: BLE001 — the shutdown goes on
        print(f"unload failed: {e!r}", file=sys.stderr, flush=True)
    FLIGHT.dump("shutdown")
    return took


if __name__ == "__main__":
    sys.exit(main())
