"""Prometheus text-format metrics for the model server (``GET /metrics``).

Counterpart of ``ollama_operator_tpu/server/metrics.py``: the same
registry (counters, callable gauges, histograms) and the same family
names, so dashboards and alert rules written for the reference read the
port. ``GLOBAL`` is this package's own registry, pre-seeded with the
families the port increments; the families of subsystems the port does
not have yet (speculative decoding, the host cache tier, disaggregated
serving, the gateway and the operator's control loops) are left out.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Tuple


class Histogram:
    DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                       5.0, 10.0, 30.0, 60.0)

    def __init__(self, buckets=DEFAULT_BUCKETS):
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.total = 0.0
        self.n = 0

    def observe(self, v: float):
        self.total += v
        self.n += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def render(self, name: str, labels: str = "") -> List[str]:
        out = []
        cum = 0
        lab = labels[:-1] + "," if labels else "{"
        for b, c in zip(self.buckets, self.counts):
            cum += c
            out.append(f'{name}_bucket{lab}le="{b}"}} {cum}')
        cum += self.counts[-1]
        out.append(f'{name}_bucket{lab}le="+Inf"}} {cum}')
        out.append(f"{name}_sum{labels} {self.total}")
        out.append(f"{name}_count{labels} {self.n}")
        return out


class Metrics:
    """Tiny registry: counters, gauges (callables), histograms."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[Tuple[str, str], float] = {}
        self._gauges: Dict[Tuple[str, str], object] = {}
        self._hists: Dict[Tuple[str, str], Histogram] = {}
        self._help: Dict[str, str] = {}

    def _key(self, name, labels):
        return (name, labels)

    def describe(self, name: str, help_: str):
        self._help[name] = help_

    def inc(self, name: str, value: float = 1.0, labels: str = ""):
        with self._lock:
            k = self._key(name, labels)
            self._counters[k] = self._counters.get(k, 0.0) + value

    def get(self, name: str, labels: str = "") -> float:
        """Current value of a counter (0.0 if never incremented)."""
        with self._lock:
            return self._counters.get(self._key(name, labels), 0.0)

    def gauge_fn(self, name: str, fn, labels: str = ""):
        with self._lock:
            self._gauges[self._key(name, labels)] = fn

    def remove_gauge(self, name: str, labels: str = ""):
        with self._lock:
            self._gauges.pop(self._key(name, labels), None)

    def observe(self, name: str, v: float, labels: str = ""):
        with self._lock:
            k = self._key(name, labels)
            if k not in self._hists:
                self._hists[k] = Histogram()
            self._hists[k].observe(v)

    def seed_histogram(self, name: str, labels: str = ""):
        """Materialise an empty histogram so its buckets scrape as 0,
        not absent — the histogram analog of the inc(name, 0.0)
        counter pre-seeds below."""
        with self._lock:
            self._hists.setdefault(self._key(name, labels), Histogram())

    def hist_buckets(self, name: str,
                     labels: str = "") -> Tuple[Tuple[float, ...],
                                                Tuple[int, ...]]:
        """(bucket upper bounds, per-bucket counts incl. the +Inf
        overflow slot) for one histogram — a snapshot callers can delta
        across a measurement window and feed to histogram_quantile-style
        interpolation (bench.py's ITL phases). Empty histogram renders
        as the default buckets with zero counts."""
        with self._lock:
            h = self._hists.get(self._key(name, labels))
            if h is None:
                return (Histogram.DEFAULT_BUCKETS,
                        (0,) * (len(Histogram.DEFAULT_BUCKETS) + 1))
            return h.buckets, tuple(h.counts)

    def hist_totals(self, name: str) -> Tuple[int, float]:
        """(observation count, value sum) aggregated across every label
        set of a histogram — e.g. total device busy-seconds across all
        tpu_model_dispatch_seconds program kinds, for the admission
        queue model's throughput estimate. (0, 0.0) when never observed."""
        with self._lock:
            n, total = 0, 0.0
            for (hname, _labels), h in self._hists.items():
                if hname == name:
                    n += h.n
                    total += h.total
            return n, total

    def render(self) -> str:
        with self._lock:
            # evaluate gauge callables FIRST: a failing one is counted in
            # tpu_model_metrics_gauge_errors_total (a silently-vanishing
            # series is how a dead weakref or a torn-down engine hides
            # from dashboards), and counters render after this pass so
            # the drop is visible in the SAME scrape. Direct dict
            # mutation, NOT self.inc(): the lock is non-reentrant.
            gauge_vals: List[Tuple[str, str, float]] = []
            for (name, labels), fn in sorted(self._gauges.items()):
                try:
                    gauge_vals.append((name, labels, float(fn())))
                except Exception:
                    k = self._key("tpu_model_metrics_gauge_errors_total",
                                  "")
                    self._counters[k] = self._counters.get(k, 0.0) + 1.0
            lines: List[str] = []
            seen = set()

            def header(name, mtype):
                if name not in seen:
                    seen.add(name)
                    if name in self._help:
                        lines.append(f"# HELP {name} {self._help[name]}")
                    lines.append(f"# TYPE {name} {mtype}")

            for (name, labels), v in sorted(self._counters.items()):
                header(name, "counter")
                lines.append(f"{name}{labels} {v}")
            for name, labels, v in gauge_vals:
                header(name, "gauge")
                lines.append(f"{name}{labels} {v}")
            for (name, labels), h in sorted(self._hists.items()):
                header(name, "histogram")
                lines.extend(h.render(name, labels))
            return "\n".join(lines) + "\n"


GLOBAL = Metrics()
GLOBAL.describe("tpu_model_generated_tokens_total",
                "Output tokens generated across all requests")
GLOBAL.describe("tpu_model_prompt_tokens_total",
                "Prompt tokens prefilled")
GLOBAL.describe("tpu_model_requests_total",
                "Completed generate requests")
GLOBAL.describe("tpu_model_ttft_seconds",
                "Time to first token")
GLOBAL.describe("tpu_model_decode_tokens_per_second",
                "Per-request steady-state decode rate")
GLOBAL.describe("tpu_model_active_slots",
                "Busy decode slots, summed over resident models")
GLOBAL.describe("tpu_model_queue_depth",
                "Requests waiting for a slot, summed over resident models")
GLOBAL.describe("tpu_model_kv_free_pages",
                "Free pages in the paged KV pools (paged models)")
GLOBAL.describe("tpu_model_radix_pages",
                "Physical KV pages pinned by the radix prefix caches")
GLOBAL.describe("tpu_model_preemptions_total",
                "Requests preempted and requeued (KV-pool pressure, "
                "priority, throttling)")
GLOBAL.describe("tpu_model_stream_frames_total",
                "Streamed NDJSON/SSE frames written (after coalescing; "
                "compare to tpu_model_generated_tokens_total for the "
                "tokens-per-frame ratio)")
GLOBAL.describe("tpu_model_engine_restarts_total",
                "Supervised in-process engine restarts after decode-loop "
                "failures (no pod restart, no model reload)")
GLOBAL.describe("tpu_model_request_timeouts_total",
                "Requests cut off mid-generation by deadline_ms (terminal"
                " frame finish reason 'timeout')")
GLOBAL.describe("tpu_model_requests_shed_total",
                "Requests shed before holding a slot: deadline expired "
                "while queued, queue full, TTFT-SLO early reject, tenant "
                "cap, or draining")
GLOBAL.describe("tpu_model_admission_stall_ms_total",
                "Wall-clock milliseconds decode dispatches spent stalled "
                "behind admission prefill work (one-shot and per chunked-"
                "prefill piece)")
GLOBAL.describe("tpu_model_prefill_chunks_total",
                "Chunked-prefill pieces dispatched (one bucket-sized "
                "piece per scheduler step)")
GLOBAL.describe("tpu_model_prefix_hit_tokens_total",
                "Prompt tokens served from the prefix cache at admission "
                "(radix page stitch or parked-slot extend) instead of "
                "being prefilled")
GLOBAL.describe("tpu_model_prefix_miss_tokens_total",
                "Prompt tokens actually prefilled at admission; hit / "
                "(hit + miss) is the prefix-cache hit rate")
GLOBAL.describe("tpu_model_prefix_reused_tokens_total",
                "Prompt tokens served from a cached prefix, counted per "
                "finished request")
GLOBAL.describe("tpu_model_itl_seconds",
                "Inter-token latency histogram, chunk-normalized: each "
                "delivered decode chunk observes (gap since previous "
                "delivery) / (tokens in chunk)")
GLOBAL.describe("tpu_model_queue_wait_seconds",
                "Submit-to-first-admission wait histogram; shed requests "
                "observe their submit-to-shed wait here too")
GLOBAL.describe("tpu_model_class_queue_wait_seconds",
                "Queue wait histogram by priority class "
                "(class=high|normal|best_effort)")
GLOBAL.describe("tpu_model_shed_total",
                "Requests shed before holding a slot, by priority class "
                "and cause "
                "(cause=queue_full|deadline|slo_predict|tenant_cap)")
GLOBAL.describe("tpu_model_tenant_throttles_total",
                "Mid-stream throttle preemptions of over-rate tenants "
                "(best-effort class only; the request resumes on the same"
                " stream once the token bucket refills)")
GLOBAL.describe("tpu_model_tenant_decode_tokens_total",
                'Decode tokens delivered per tenant (tenant="default" is '
                "the no-key bucket)")
GLOBAL.describe("tpu_model_dispatch_seconds",
                "Device dispatch latency histogram by program kind "
                "(kind=decode|admit|extend): launch to tokens on the host")
GLOBAL.describe("tpu_model_metrics_gauge_errors_total",
                "Gauge callables that raised during /metrics render; a "
                "nonzero rate means a series is silently missing from "
                "scrapes")
GLOBAL.describe("tpu_model_hbm_bytes_in_use",
                "Device memory the process's allocator holds on the card "
                "(torch.cuda.memory_allocated; 0 on the CPU)")
GLOBAL.describe("tpu_model_flight_recorder_events",
                "Structured events recorded into the flight-recorder ring"
                " so far (runtime/trace.py)")
GLOBAL.describe("tpu_model_flight_recorder_dumps",
                "Flight-recorder dumps written to stderr (supervised "
                "restarts and shutdown)")
GLOBAL.describe("tpu_model_replayed_requests_total",
                "In-flight streams recovered across a supervised engine "
                "restart by replay (re-prefill of prompt+generated, "
                "continuation on the same stream) instead of an error "
                "frame")
GLOBAL.describe("tpu_model_replayed_tokens_total",
                "Prompt+generated tokens re-prefilled by restart replay; "
                "bounded per restart by TPU_RESTART_REPLAY_TOKENS")
GLOBAL.describe("tpu_model_replay_fallback_total",
                "In-flight streams that could not be replayed across a "
                "restart and got the exactly-once error instead, by cause"
                " (cause=nondeterministic|over_budget|faulted|broken)")
GLOBAL.describe("tpu_model_drain_started_total",
                "Graceful-drain activations (SIGTERM / POST /api/drain): "
                "new submits shed 503 while running streams finish")
GLOBAL.describe("tpu_model_drain_shed_total",
                "Requests shed by graceful drain: new submits refused "
                "while draining, plus stragglers cut at "
                "TPU_DRAIN_TIMEOUT_S")
GLOBAL.describe("tpu_model_watchdog_fires_total",
                "Hung-dispatch watchdog fires (dispatch wait exceeded "
                "TPU_DISPATCH_WATCHDOG_MS or the histogram-derived "
                "ceiling); each one forces a supervised restart + replay")
GLOBAL.describe("tpu_model_useful_tokens_total",
                "Useful token positions computed per dispatch kind "
                "(kind=decode|prefill): active slots' steps, real prompt "
                "positions")
GLOBAL.describe("tpu_model_padded_tokens_total",
                "Padding-waste token positions per dispatch kind: empty "
                "batch slots x steps, prefill bucket positions past the "
                "prompt chunk")
GLOBAL.describe("tpu_model_model_flops_total",
                "Analytic model FLOPs issued for active slots (matmul "
                "terms only); rate() over this / peak = MFU over any "
                "window")
GLOBAL.describe("tpu_model_breakdown_seconds_total",
                "Scheduler wall-clock classified by phase "
                "(phase=dispatch_wait|host|idle)")
GLOBAL.describe("tpu_model_mfu",
                "Achieved model-FLOPs utilization vs the device's dense "
                "bf16 peak over the last 60s, summed over resident models"
                " (0 when no peak is known: the CPU without "
                "TPU_PEAK_FLOPS)")
GLOBAL.describe("tpu_model_goodput_tokens_per_second",
                "Useful tokens per second over the last 60s, summed over "
                "resident models")
# pre-seed the counters at 0: alert rules rate() over these, and a series
# that first appears AT the first failure hides that failure
for _name in ("tpu_model_engine_restarts_total",
              "tpu_model_request_timeouts_total",
              "tpu_model_requests_shed_total",
              "tpu_model_admission_stall_ms_total",
              "tpu_model_prefill_chunks_total",
              "tpu_model_prefix_hit_tokens_total",
              "tpu_model_prefix_miss_tokens_total",
              "tpu_model_preemptions_total",
              "tpu_model_requests_total",
              "tpu_model_generated_tokens_total",
              "tpu_model_prompt_tokens_total",
              "tpu_model_stream_frames_total",
              "tpu_model_prefix_reused_tokens_total",
              "tpu_model_replayed_requests_total",
              "tpu_model_replayed_tokens_total",
              "tpu_model_drain_started_total",
              "tpu_model_drain_shed_total",
              "tpu_model_watchdog_fires_total",
              "tpu_model_metrics_gauge_errors_total",
              "tpu_model_model_flops_total"):
    GLOBAL.inc(_name, 0.0)
# replay fallbacks by cause
for _cause in ("nondeterministic", "over_budget", "faulted", "broken"):
    GLOBAL.inc("tpu_model_replay_fallback_total", 0.0,
               f'{{cause="{_cause}"}}')
# admission control: every class x cause combination, so overload alert
# rules (and the tpu_model_shed_total{class="high"} == 0 check) read 0,
# not absent. Label keys in the order admission.shed_labels writes them
for _class in ("high", "normal", "best_effort"):
    for _cause in ("queue_full", "deadline", "slo_predict", "tenant_cap"):
        GLOBAL.inc("tpu_model_shed_total", 0.0,
                   f'{{class="{_class}",cause="{_cause}"}}')
GLOBAL.inc("tpu_model_tenant_throttles_total", 0.0,
           '{class="best_effort",tenant="default"}')
GLOBAL.inc("tpu_model_tenant_decode_tokens_total", 0.0,
           '{tenant="default"}')
# utilization accounting (runtime/accounting.py)
for _kind in ("decode", "prefill"):
    GLOBAL.inc("tpu_model_useful_tokens_total", 0.0, f'{{kind="{_kind}"}}')
    GLOBAL.inc("tpu_model_padded_tokens_total", 0.0, f'{{kind="{_kind}"}}')
for _phase in ("dispatch_wait", "host", "idle"):
    GLOBAL.inc("tpu_model_breakdown_seconds_total", 0.0,
               f'{{phase="{_phase}"}}')
# the latency histograms scrape as empty buckets, not "no data"
for _name in ("tpu_model_ttft_seconds", "tpu_model_queue_wait_seconds",
              "tpu_model_itl_seconds"):
    GLOBAL.seed_histogram(_name)
for _kind in ("decode", "admit", "extend"):
    GLOBAL.seed_histogram("tpu_model_dispatch_seconds", f'{{kind="{_kind}"}}')


class Stopwatch:
    def __init__(self):
        self.t0 = time.monotonic()

    def elapsed(self):
        return time.monotonic() - self.t0
