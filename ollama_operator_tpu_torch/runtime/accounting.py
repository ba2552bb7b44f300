"""Utilization and goodput accounting: the analytic FLOPs/MFU model,
occupancy and padding-waste tracking, and a wall-clock breakdown.

Counterpart of ``ollama_operator_tpu/runtime/accounting.py`` (a copy, with
the device peak read from the card's name). Three instruments, host-side
only:

1. **Analytic per-dispatch FLOPs model** from ``models/config.py`` in the
   MFU convention of Chowdhery et al. (PaLM): matmul FLOPs only
   (projections + attention + MLP + lm-head). Closed forms: the attention
   term over a span of positions is an arithmetic series.

2. **Goodput split**: every dispatch's slot·step grid is divided into
   useful tokens (active slots, real prompt positions) and bucket-padding
   waste (empty batch slots, prefill positions beyond the prompt chunk).
   Occupancy is the token-weighted useful fraction (Orca's
   continuous-batching efficiency).

3. **Wall-clock breakdown**: scheduler time classified into dispatch-wait
   (blocked on the device), idle (no work queued) and host overhead
   (everything else: detokenizing, HTTP, Python, and on this port the
   eager decode loop's launches).

MFU counts FLOPs issued for *active* slots only; padded batch slots and
padded prefill positions are excluded (``waste_pct`` reports them). The
peak is the card's dense bf16 tensor-core rate from NVIDIA's public data
sheets, matched on ``torch.cuda.get_device_name``; ``TPU_PEAK_FLOPS``
overrides it. On the CPU there is no meaningful peak: MFU reads null
unless the override is set.

Kill switch: ``TPU_ACCOUNTING=0`` swaps the scheduler's accounting for the
shared no-op instance.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Any, Dict, Iterable, List, Optional, Tuple

from ..models.config import ModelConfig
from ..server.metrics import GLOBAL as METRICS

# Kill switch, read at Scheduler construction.
ACCOUNTING_ENABLED = os.environ.get(
    "TPU_ACCOUNTING", "1") not in ("0", "false", "")

# How many seconds of per-second aggregates /debug/utilization keeps.
RING_SECONDS = int(os.environ.get("TPU_ACCOUNTING_RING_S", "120"))

# Dense bf16 tensor-core peak FLOPs/s per card (NVIDIA data sheets; the
# sheets' "with sparsity" figures halved). Matched as substrings of
# torch.cuda.get_device_name(), most specific first: the SXM part names
# itself "NVIDIA H100 80GB HBM3".
PEAK_FLOPS_BY_NAME: Tuple[Tuple[str, float], ...] = (
    ("h100 pcie", 756e12),
    ("h100 nvl", 835e12),
    ("h100", 989e12),
)


def detect_peak_flops(device=None) -> Tuple[float, str]:
    """Return (peak_flops_per_s, device_kind) for ``device`` (a torch
    device or its name; None: the current CUDA device when there is one).

    ``TPU_PEAK_FLOPS`` wins over detection (the only way to get an MFU on
    the CPU); 0.0 means "no meaningful peak" and MFU reads null."""
    env = os.environ.get("TPU_PEAK_FLOPS", "")
    if env:
        try:
            return float(env), "override"
        except ValueError:
            pass
    try:
        import torch  # noqa: PLC0415 — deliberate lazy import
        dev = (torch.device(device) if device is not None
               else torch.device("cuda") if torch.cuda.is_available()
               else torch.device("cpu"))
        if dev.type != "cuda":
            return 0.0, dev.type
        kind = torch.cuda.get_device_name(dev)
    except Exception:  # noqa: BLE001 — no device to ask
        return 0.0, "unknown"
    low = kind.lower()
    for key, peak in PEAK_FLOPS_BY_NAME:
        if key in low:
            return peak, kind
    return 0.0, kind


# --- analytic FLOPs model ---------------------------------------------------
#
# Matmul-only per-position cost split into a context-independent base and a
# context-proportional attention term:
#
#   flops(position p) = base + 4 * q_dim * Σ_layers attended_keys(p, layer)
#
# where attended_keys is p+1 on full-attention layers and min(p+1, window)
# on sliding-window layers (gemma2/3 alternate by sliding_pattern).  Spans
# of positions sum the attention term as an arithmetic series.


def _layer_split(cfg: ModelConfig) -> Tuple[int, int]:
    """(full_attention_layers, sliding_window_layers)."""
    L = cfg.n_layers
    if cfg.sliding_window <= 0:
        return L, 0
    if cfg.altern_sliding:
        p = cfg.sliding_pattern
        full = sum(1 for i in range(L) if i % p == p - 1)
        return full, L - full
    return 0, L


def _ctx_sum(start: int, n: int, window: int = 0) -> float:
    """Σ over positions p in [start, start+n) of attended key count
    (p+1, capped at `window` when nonzero) — closed form, no loop."""
    if n <= 0:
        return 0.0
    end = start + n
    if window and start + 1 >= window:
        return float(n * window)
    if window and end > window:
        n_lin = window - start
        lin = (start + 1 + window) * n_lin / 2.0
        return lin + (end - window) * float(window)
    return (start + 1 + end) * n / 2.0


def per_token_flops(cfg: ModelConfig) -> float:
    """Context-independent matmul FLOPs for one position: per-layer
    projections + MLP (dense or MoE top-k + shared expert + router) plus
    the lm-head.  The lm-head is counted for every position — the engine
    really computes logits for the whole padded step, and on the tiny CI
    configs it dominates; the docs carry the caveat."""
    d, f, L, v = cfg.dim, cfg.ffn_dim, cfg.n_layers, cfg.vocab_size
    q, kv = cfg.q_dim, cfg.kv_dim
    proj = 2 * (d * q + 2 * d * kv + q * d)
    mlp_mult = 6 if cfg.mlp_type == "gated" else 4
    mlp = mlp_mult * d * f
    if cfg.n_experts:
        mlp = cfg.n_experts_used * mlp + 2 * d * cfg.n_experts
        if cfg.n_shared_ffn:
            mlp += 6 * d * cfg.n_shared_ffn
    head = 2 * d * v
    return float(L * (proj + mlp) + head)


def attn_span_flops(cfg: ModelConfig, start: int, n: int) -> float:
    """Attention score+value matmul FLOPs (4·q_dim per attended key) for
    positions [start, start+n), respecting sliding windows per layer."""
    full, sliding = _layer_split(cfg)
    tot = full * _ctx_sum(start, n)
    if sliding:
        tot += sliding * _ctx_sum(start, n, cfg.sliding_window)
    return 4.0 * cfg.q_dim * tot


def prefill_flops(cfg: ModelConfig, start: int, n: int) -> float:
    """One prefill chunk: `n` real prompt positions beginning at absolute
    position `start` (chunked prefill passes start=job.done)."""
    return n * per_token_flops(cfg) + attn_span_flops(cfg, start, n)


def decode_flops(cfg: ModelConfig, ctx: int, n_steps: int = 1) -> float:
    """`n_steps` autoregressive steps for one slot whose attended context
    is `ctx` keys at the first step (step j attends ctx+j)."""
    return (n_steps * per_token_flops(cfg)
            + attn_span_flops(cfg, ctx - 1, n_steps))


# --- accumulator ------------------------------------------------------------

_KINDS = ("decode", "prefill")


class UtilizationAccounting:
    """Thread-safe accumulator fed by the scheduler's dispatch sites.

    Totals are monotone (Prometheus counters mirror them); the per-second
    ring backs `GET /debug/utilization` and the windowed rates in
    `snapshot()` (MFU, goodput tok/s, occupancy).
    """

    enabled = True

    def __init__(self, cfg: Optional[ModelConfig] = None,
                 peak_flops: Optional[float] = None,
                 device_kind: Optional[str] = None, device=None):
        self.cfg = cfg
        if peak_flops is None:
            peak_flops, detected = detect_peak_flops(device)
            if device_kind is None:
                device_kind = detected
        self.peak_flops = float(peak_flops or 0.0)
        self.device_kind = device_kind or "unknown"
        self._base = per_token_flops(cfg) if cfg is not None else 0.0
        self._lock = threading.Lock()
        self._t_start = time.monotonic()
        self.useful_tokens: Dict[str, float] = {k: 0.0 for k in _KINDS}
        self.padded_tokens: Dict[str, float] = {k: 0.0 for k in _KINDS}
        self.model_flops = 0.0
        self.wait_s = 0.0
        self.idle_s = 0.0
        self.dispatches: Dict[str, int] = {k: 0 for k in _KINDS}
        # per-second ring: {int(monotonic): [flops, useful, padded, busy_s]}
        self._ring: Dict[int, List[float]] = {}
        # incremental host-overhead attribution: between consecutive
        # wait/idle events every elapsed second not spent blocked is
        # host work (detok, HTTP, Python) — synced into the phase counter
        self._synced_wall = self._t_start

    # -- feed sites ----------------------------------------------------------

    def _bump(self, kind: str, flops: float, useful: float,
              padded: float, dur_s: float) -> None:
        now = int(time.monotonic())
        with self._lock:
            self.useful_tokens[kind] += useful
            self.padded_tokens[kind] += padded
            self.model_flops += flops
            self.dispatches[kind] += 1
            cell = self._ring.get(now)
            if cell is None:
                cell = self._ring[now] = [0.0, 0.0, 0.0, 0.0]
                if len(self._ring) > RING_SECONDS + 8:
                    cutoff = now - RING_SECONDS
                    for t in [t for t in self._ring if t < cutoff]:
                        del self._ring[t]
            cell[0] += flops
            cell[1] += useful
            cell[2] += padded
            cell[3] += dur_s
        METRICS.inc("tpu_model_useful_tokens_total", useful,
                    f'{{kind="{kind}"}}')
        METRICS.inc("tpu_model_padded_tokens_total", padded,
                    f'{{kind="{kind}"}}')
        METRICS.inc("tpu_model_model_flops_total", flops)

    def on_decode(self, dur_s: float, ctxs: Iterable[int], n_steps: int,
                  capacity: int) -> None:
        """One (possibly multi-step) decode dispatch: `ctxs` are the
        attended context lengths of the ACTIVE slots at the first step,
        `capacity` the padded batch bucket the device actually ran."""
        if self.cfg is None:
            return
        flops = 0.0
        n_active = 0
        for c in ctxs:
            n_active += 1
            flops += (n_steps * self._base
                      + attn_span_flops(self.cfg, c - 1, n_steps))
        useful = float(n_active * n_steps)
        padded = float(max(0, capacity - n_active) * n_steps)
        self._bump("decode", flops, useful, padded, dur_s)

    def on_prefill(self, dur_s: float, start: int, n_new: int,
                   bucket: int) -> None:
        """One prefill chunk (admit / extend / one admit_many member):
        `n_new` real prompt positions from absolute position `start`,
        padded to `bucket` on device."""
        if self.cfg is None or n_new <= 0:
            return
        flops = prefill_flops(self.cfg, start, n_new)
        padded = float(max(0, bucket - n_new))
        self._bump("prefill", flops, float(n_new), padded, dur_s)

    def _sync_phase(self, phase: str, dur_s: float) -> None:
        """Fold a blocked interval into the phase counters; the wall time
        since the previous sync minus the blocked part is host overhead."""
        now = time.monotonic()
        with self._lock:
            host = max(0.0, (now - self._synced_wall) - dur_s)
            self._synced_wall = now
        METRICS.inc("tpu_model_breakdown_seconds_total", dur_s,
                    f'{{phase="{phase}"}}')
        if host > 0.0:
            METRICS.inc("tpu_model_breakdown_seconds_total", host,
                        '{phase="host"}')

    def on_wait(self, dur_s: float) -> None:
        with self._lock:
            self.wait_s += dur_s
        self._sync_phase("dispatch_wait", dur_s)

    def on_idle(self, dur_s: float) -> None:
        with self._lock:
            self.idle_s += dur_s
        self._sync_phase("idle", dur_s)

    # -- reads ---------------------------------------------------------------

    def breakdown(self) -> Dict[str, float]:
        with self._lock:
            wall = time.monotonic() - self._t_start
            wait, idle = self.wait_s, self.idle_s
        host = max(0.0, wall - wait - idle)
        return {"wall_s": round(wall, 3),
                "dispatch_wait_s": round(wait, 3),
                "idle_s": round(idle, 3),
                "host_s": round(host, 3)}

    def snapshot(self, window_s: float = 60.0) -> Dict[str, Any]:
        """Windowed rates + lifetime totals; the `/api/ps` utilization
        block and the operator's CR status mirror read this."""
        now = int(time.monotonic())
        window = max(1, min(int(window_s), RING_SECONDS))
        with self._lock:
            flops = useful = padded = busy = 0.0
            secs = 0
            for t, cell in self._ring.items():
                # skip the in-progress second so rates aren't biased low
                if now - window <= t < now:
                    flops += cell[0]
                    useful += cell[1]
                    padded += cell[2]
                    busy += cell[3]
                    secs += 1
            elapsed = min(window, max(1.0, time.monotonic() - self._t_start))
            totals = {
                "useful_tokens": dict(self.useful_tokens),
                "padded_tokens": dict(self.padded_tokens),
                "model_flops": self.model_flops,
                "dispatches": dict(self.dispatches),
            }
        issued = useful + padded
        mfu = (flops / elapsed / self.peak_flops) if self.peak_flops else None
        return {
            "enabled": True,
            "device_kind": self.device_kind,
            "peak_flops": self.peak_flops or None,
            "window_s": window,
            "mfu": (round(mfu, 6) if mfu is not None else None),
            "model_flops_per_s": round(flops / elapsed, 1),
            "goodput_tok_s": round(useful / elapsed, 2),
            "occupancy": round(useful / issued, 4) if issued else None,
            "waste_pct": round(100.0 * padded / issued, 2) if issued else 0.0,
            "busy_s": round(busy, 3),
            "active_seconds": secs,
            "breakdown": self.breakdown(),
            "totals": totals,
        }

    def ring(self, last: int = 60) -> List[Dict[str, Any]]:
        """Per-second aggregates, oldest first — /debug/utilization."""
        with self._lock:
            items = sorted(self._ring.items())[-max(1, last):]
            t_now = int(time.monotonic())
        return [{"t_rel_s": t - t_now, "model_flops": cell[0],
                 "useful_tokens": cell[1], "padded_tokens": cell[2],
                 "busy_ms": round(cell[3] * 1e3, 3)}
                for t, cell in items]


class _NullAccounting:
    """Shared no-op stand-in when TPU_ACCOUNTING=0: call sites never
    branch."""

    enabled = False
    cfg = None
    peak_flops = 0.0
    device_kind = "disabled"
    model_flops = 0.0

    def on_decode(self, *a: Any, **kw: Any) -> None:
        pass

    def on_prefill(self, *a: Any, **kw: Any) -> None:
        pass

    def on_wait(self, dur_s: float) -> None:
        pass

    def on_idle(self, dur_s: float) -> None:
        pass

    def breakdown(self) -> Dict[str, float]:
        return {}

    def snapshot(self, window_s: float = 60.0) -> Dict[str, Any]:
        return {"enabled": False}

    def ring(self, last: int = 60) -> List[Dict[str, Any]]:
        return []


NULL_ACCOUNTING = _NullAccounting()


def make_accounting(cfg: Optional[ModelConfig], device=None):
    """Factory the scheduler calls at construction (``device``: the
    engine's); honors the module kill switch at call time."""
    if not ACCOUNTING_ENABLED:
        return NULL_ACCOUNTING
    return UtilizationAccounting(cfg, device=device)
