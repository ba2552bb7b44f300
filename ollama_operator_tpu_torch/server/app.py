"""Model manager + Ollama-compatible HTTP server (stdlib, threaded).

Counterpart of ``ollama_operator_tpu/server/app.py`` for the routes this
port serves:

  GET  /                  liveness banner (HEAD / too)
  GET  /api/version
  GET  /api/tags          the models in the blob store, then the models
                          built in-process
  GET  /api/ps            the resident models (serving dtype, cache kind,
                          keep-alive deadline, bytes on the card, and the
                          process's kernel launch counts)
  POST /api/pull          pull a model from its registry into the blob
                          store, progress streamed (NDJSON) or not
  POST /api/push          push a store model to its registry (HEAD a
                          blob, upload what it lacks, then the manifest)
  POST /api/blobs/<digest>  a client's blob upload (the body, checked
                          against its sha256); HEAD: is it in the store?
  POST /api/create        a store model from a Modelfile (``modelfile``),
                          an uploaded GGUF (``files``) or a model name
                          (``from``): FROM @digest, FROM a store model
                          (its layers inherited, parameters merged) or
                          FROM a server-side path; progress streamed
  POST /api/copy          another name for a store model's manifest
  POST /api/show          modelfile, template, parameters, details
  DELETE /api/delete      remove a model from the store (POST too)
  POST /api/embed         embeddings of ``input`` (a string or a list);
                          /api/embeddings of ``prompt``; /v1/embeddings
                          (OpenAI) of ``input``: a decoder's mean-pooled
                          final hidden states, or a BERT encoder's pooled
                          output, unnormalized, as the JAX server gives
                          them
  POST /api/generate      generation, streamed (NDJSON) or not; ``suffix``
                          (fill-in-middle) as the reference renders it,
                          ``format`` ("json" or a JSON schema) decoded
                          under its grammar, ``images`` (base64) through a
                          llava model's vision tower (400 on a model
                          without a projector), ``keep_alive`` parsed as
                          the reference does
  POST /api/chat          chat-templated generation (NDJSON): system
                          messages merged, ``tools`` rendered through the
                          template's ``.Tools`` and answered as one message
                          with ``tool_calls``, ``format``, ``keep_alive``
                          (0 with no messages unloads), ``images`` of
                          every message
  POST /v1/chat/completions   OpenAI chat (SSE when streamed), with
                          ``response_format`` (json_object, json_schema)
                          and ``tools``
  POST /v1/completions    OpenAI text completion
  GET  /v1/models         OpenAI model list
  GET  /healthz, /livez, /readyz   the pod's probes: /healthz answers
                          once the server listens (startup); /livez and
                          /readyz answer 503 when a resident model's
                          engine failed for good, and /readyz 503
                          "draining" while the server drains (/livez
                          stays 200 then, so the kubelet does not kill a
                          pod mid-drain)
  GET  /metrics           Prometheus text (``server/metrics.py``)
  GET  /debug/trace?id=   a recent request's span timeline (no id: the
                          ids held); /debug/events the flight recorder's
                          ring (?kind=, ?last=); /debug/utilization a
                          model's per-second utilization ring (?model=,
                          ?last=)
  POST /api/drain         start a graceful drain (the operator's
                          drain-first shrink): new work is shed with 503
                          and Retry-After, running streams finish

An embedding model (a BERT GGUF) loads as ``runtime/service.EmbeddingModel``
(f32, no engine); generation on it answers 400.

Streamed responses are coalesced as the reference's are: the first piece
goes out alone, then a frame every ``stream_flush_tokens`` tokens (16) or
``stream_flush_ms`` (25 ms), whichever comes first; the request's options
override ``TPU_STREAM_FLUSH_TOKENS`` / ``TPU_STREAM_FLUSH_MS``, which
override the defaults. An error after the stream started is its last
frame (an SSE error event and ``[DONE]`` on the OpenAI route). Before it
started, a request shed while queued (its deadline passed, a higher
class displaced it, the server drains, the queue is full, the TTFT SLO
cannot be met) answers 503 with ``Retry-After``, a tenant over its queued
cap 429 with ``Retry-After``. Every generation route takes the
fair-queuing tenant from ``X-Tenant``, else from a hash of ``X-API-Key``
or ``Authorization``, when the options name none.

The manager owns the blob store (``server/registry.py``) and loads a model
from it on demand, as the JAX manager does: the GGUF is read, dequantized
and transcoded (``gguf/transcode.py``, cached under ``cache_dir``), and
served in the weight dtype resolved per model. A store-loaded model is
unloaded after its keep-alive idle time (``OLLAMA_KEEP_ALIVE``, 5 minutes
by default) and comes back on its next request. Models built in-process
(``ModelManager.preload`` from dense params, or ``ModelManager.add``) have
no source to come back from, so they stay resident until stopped. With
``serve_models=False`` (``--store-only``) the manager serves the store's
routes and refuses generation with 503; it touches no device.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import re
import sys
import threading
import time
import weakref
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional, Tuple

import torch

from .. import __version__
from ..convert import params_from_numpy
from ..device import resolve_device
from ..gguf.reader import GGUFFile
from ..gguf.lora import apply_lora
from ..gguf.transcode import (config_from_gguf, encoder_config_from_gguf,
                              is_encoder_arch, load_encoder_params,
                              load_model as transcode_load,
                              load_vision_params, vision_config_from_gguf)
from ..models.decoder import check_supported
from ..ops import cuda_build
from ..ops import quant as Q
from ..runtime.admission import TenantRateLimited, tenant_from_key
from ..runtime.engine import (EngineConfig, resolve_engine_dtype,
                              resolve_serving_defaults)
from ..runtime.errors import BadRequest, DeadlineExceeded
from ..runtime.scheduler import SchedulerBroken, SchedulerBusy
from ..runtime.service import EmbeddingModel, LoadedModel
from ..runtime.trace import FLIGHT, TRACER
from ..tokenizer import Tokenizer
from .metrics import GLOBAL as METRICS
from .modelfile import Modelfile, params_json, parse_modelfile
from .names import ModelName
from .registry import (MT_ADAPTER, MT_LICENSE, MT_MODEL, MT_PARAMS,
                       MT_PROJECTOR, MT_SYSTEM, MT_TEMPLATE, ModelStore,
                       RegistryClient, RegistryError, valid_blob_digest)
from .tools import split_tool_calls

ENGINE_DTYPES = ("bfloat16", "float32", "int8", "int4")


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")


# stream coalescing defaults: a frame every N tokens or T ms, whichever
# comes first (the first piece always goes out at once: it carries TTFT)
STREAM_FLUSH_TOKENS = 16
STREAM_FLUSH_MS = 25.0


def resolve_stream_flush(options: Optional[Dict]) -> Tuple[int, float]:
    """(tokens a frame, seconds between frames) for stream coalescing.

    The request's options (``stream_flush_tokens``, ``stream_flush_ms``)
    override the environment (``TPU_STREAM_FLUSH_TOKENS``,
    ``TPU_STREAM_FLUSH_MS``), which overrides the defaults;
    ``stream_flush_tokens: 1`` gives a frame a piece."""
    o = options or {}
    try:
        n = int(o.get("stream_flush_tokens",
                      os.environ.get("TPU_STREAM_FLUSH_TOKENS",
                                     STREAM_FLUSH_TOKENS)))
    except (TypeError, ValueError):
        n = STREAM_FLUSH_TOKENS
    try:
        ms = float(o.get("stream_flush_ms",
                         os.environ.get("TPU_STREAM_FLUSH_MS",
                                        STREAM_FLUSH_MS)))
    except (TypeError, ValueError):
        ms = STREAM_FLUSH_MS
    return max(1, n), max(0.0, ms) / 1000.0


class _StreamCoalescer:
    """Batches streamed text pieces into wire frames: the first piece
    goes out at once (it is the TTFT token); after it a frame goes out
    every ``max_tokens`` tokens (a piece counts its ``n_tokens``, else 1)
    or ``max_s`` seconds, whichever comes first. ``frames`` counts the
    frames sent."""

    def __init__(self, chunk_fn, make_frame, max_tokens: int, max_s: float,
                 trace=None):
        self._chunk = chunk_fn
        self._make = make_frame
        self.max_tokens = max_tokens
        self.max_s = max_s
        self._parts: List[str] = []
        self._ntok = 0
        self._t_last = None     # None: the first piece goes out at once
        self.frames = 0
        # the request's span timeline: each flush is stamped on it
        self._trace = trace

    def add(self, piece: str):
        self._parts.append(piece)
        self._ntok += getattr(piece, "n_tokens", 1)
        now = time.monotonic()
        if (self._t_last is None or self._ntok >= self.max_tokens
                or now - self._t_last >= self.max_s):
            self.flush(now)

    def flush(self, now: Optional[float] = None):
        if not self._parts:
            return
        text = "".join(self._parts)
        n_tok = self._ntok
        self._parts.clear()
        self._ntok = 0
        self._t_last = time.monotonic() if now is None else now
        self._chunk(self._make(text))
        self.frames += 1
        METRICS.inc("tpu_model_stream_frames_total")
        if self._trace is not None:
            self._trace.event("http_flush", n_tokens=n_tok, chars=len(text))


def _fmt_params(n: int) -> str:
    if n >= 1e9:
        return f"{n / 1e9:.1f}B"
    return f"{n / 1e6:.0f}M"


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


def parse_keep_alive(v) -> Optional[float]:
    """Ollama keep_alive → seconds (None = keep forever).

    Accepts numbers (seconds; negative = forever) and Go-style duration
    strings ("5m", "1h30m", "300ms", "-1"). 0 means "unload as soon as
    idle"; anything else raises :class:`BadRequest`."""
    if v is None:
        raise BadRequest("keep_alive is None")
    if isinstance(v, bool):
        raise BadRequest(f"bad keep_alive {v!r}")
    if isinstance(v, (int, float)):
        if not math.isfinite(v):
            raise BadRequest(f"bad keep_alive {v!r}")
        return None if v < 0 else float(v)
    s = str(v).strip()
    if not s:
        raise BadRequest("empty keep_alive")
    try:
        n = float(s)
        if not math.isfinite(n):
            raise ValueError
        return None if n < 0 else n
    except ValueError:
        pass
    m = re.fullmatch(r"(-?)((?:\d+(?:\.\d+)?(?:ns|us|µs|ms|s|m|h))+)", s)
    if not m:
        raise BadRequest(f"bad keep_alive {v!r}")
    if m.group(1):
        return None
    unit_s = {"ns": 1e-9, "us": 1e-6, "µs": 1e-6, "ms": 1e-3,
              "s": 1.0, "m": 60.0, "h": 3600.0}
    total = 0.0
    for num, unit in re.findall(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h)", s):
        total += float(num) * unit_s[unit]
    return total


def apply_engine_dtype(params: Dict[str, Any], engine_dtype: str,
                       device) -> Dict[str, Any]:
    """Dense params → the serving tree for ``engine_dtype``, as the JAX
    loader builds it: every leaf is moved to ``device`` in the activation
    dtype (bf16 on the card, f32 on the CPU or for "float32"), then for
    "int8"/"int4" the matmul leaves are quantized (``quantize_params``,
    which pops them from the tree one at a time). Raises for a tree whose
    leaves are already quantized."""
    if engine_dtype not in ENGINE_DTYPES:
        raise ValueError(f"weight dtype {engine_dtype!r}; expected one of "
                         f"{ENGINE_DTYPES}")
    quantized = [k for k, v in (*params.items(),
                                *params.get("layers", {}).items())
                 if Q.is_quantized(v)]
    if quantized:
        raise ValueError(f"leaves {quantized} are already quantized; "
                         f"preload takes dense params")
    dev = torch.device(device)
    act = (torch.float32 if dev.type == "cpu" or engine_dtype == "float32"
           else torch.bfloat16)

    def cast(tree):
        return {k: (cast(v) if isinstance(v, dict)
                    else v.to(device=dev, dtype=act))
                for k, v in ((k, tree.pop(k)) for k in list(tree))}

    out = cast(params)
    if engine_dtype in ("int8", "int4"):
        out = Q.quantize_params(out, bits=8 if engine_dtype == "int8" else 4)
    return out


# GGUF general.file_type → Ollama's quantization label
_FILE_TYPES = {0: "F32", 1: "F16", 2: "Q4_0", 3: "Q4_1", 7: "Q8_0",
               8: "Q5_0", 9: "Q5_1", 10: "Q2_K", 11: "Q3_K_S",
               12: "Q3_K_M", 13: "Q3_K_L", 14: "Q4_K_S", 15: "Q4_K_M",
               16: "Q5_K_S", 17: "Q5_K_M", 18: "Q6_K"}


def transcode_dtype(engine_dtype: str, device) -> str:
    """The dtype a GGUF is transcoded (and cached) in for serving in
    ``engine_dtype``: float32 for float32 weights and on the CPU, where
    :func:`apply_engine_dtype` serves f32 activations; bfloat16 on the card,
    also for int8 and int4, which quantize from it."""
    return ("float32" if engine_dtype == "float32"
            or torch.device(device).type == "cpu" else "bfloat16")


class ModelManager:
    """The blob store and the resident models, all on one device (the card
    unless the caller asks for the CPU).

    ``store_root``: the blob store (the shared volume), from which
    :meth:`load` builds a model on demand; None for a manager of
    in-process models only. ``cache_dir``: the transcoded-weights cache.
    ``engine_dtype``: the weight dtype of store-loaded models (None:
    resolved per model, :func:`resolve_engine_dtype`). ``ecfg``: their
    engine config before :func:`resolve_serving_defaults` (None: the
    model's context capped by its ``num_ctx`` parameter, as the JAX
    manager builds it). ``serve_models=False`` is the store-only role: no
    device, no engine, generation refused with 503.
    ``default_keep_alive`` (else ``OLLAMA_KEEP_ALIVE``, else 5 minutes)
    is the idle time after which a store-loaded model is unloaded;
    ``clock`` is the reaper's clock and ``reap_every_s`` its period.

    ``begin_drain`` (SIGTERM, ``POST /api/drain``) puts every resident
    model, and every model loaded after it, into draining: ``/readyz``
    answers 503 and new work is shed while running streams finish;
    ``drain`` also waits for them, up to ``TPU_DRAIN_TIMEOUT_S``."""

    def __init__(self, store_root: Optional[str] = None,
                 cache_dir: Optional[str] = None, device="cuda",
                 ecfg: Optional[EngineConfig] = None,
                 engine_dtype: Optional[str] = None,
                 serve_models: bool = True, default_keep_alive=None,
                 clock=time.monotonic, reap_every_s: float = 1.0):
        if engine_dtype is not None and engine_dtype not in ENGINE_DTYPES:
            raise ValueError(f"weight dtype {engine_dtype!r}; expected one "
                             f"of {ENGINE_DTYPES}")
        self.serve_models = serve_models
        self.device = resolve_device(device) if serve_models else None
        self.store = ModelStore(store_root) if store_root else None
        self.client = RegistryClient(self.store) if self.store else None
        self.cache_dir = cache_dir
        self.ecfg = ecfg
        self.engine_dtype = engine_dtype
        self._models: Dict[str, LoadedModel] = {}
        self._lock = threading.Lock()
        self._load_lock = threading.Lock()
        self._clock = clock
        # name → idle-unload deadline on ``clock`` (None: keep forever),
        # for the store-loaded models only
        self._expires: Dict[str, Optional[float]] = {}
        raw_ka = (default_keep_alive if default_keep_alive is not None
                  else (os.environ.get("OLLAMA_KEEP_ALIVE") or "5m"))
        try:
            self.default_keep_alive = parse_keep_alive(raw_ka)
        except ValueError:
            # a malformed env var must not keep the pod from booting
            print(f"warning: invalid OLLAMA_KEEP_ALIVE {raw_ka!r}; using "
                  f"5m", file=sys.stderr)
            self.default_keep_alive = 300.0
        self._reaper_stop = threading.Event()
        self.draining = False
        # generation requests inside a handler (the shutdown waits for
        # them to write their last frame)
        self._inflight = 0
        self._inflight_cv = threading.Condition()
        if serve_models and self.store is not None:
            self._reaper = threading.Thread(
                target=self._reap_loop, args=(reap_every_s,), daemon=True,
                name="keepalive-reaper")
            self._reaper.start()

    # -- in-process models ---------------------------------------------
    def preload(self, name: str, cfg, params, tokenizer,
                dtype: Optional[str] = None, **kw) -> LoadedModel:
        """Build a LoadedModel on the manager's device from dense
        ``params`` and add it. The weights are served in ``dtype``
        ("bfloat16", "float32", "int8", "int4") when the caller names
        one, else in the dtype resolved for this model and device
        (``resolve_engine_dtype``: int8 below 4e9 parameters and int4
        above on the card, f32 on the CPU). ``params`` is consumed: its
        leaves are popped as they are converted. Other keywords go to
        :class:`LoadedModel` (``kv_dtype``, ``paged``, ``ecfg``, and
        ``vision``: a (``VisionConfig``, params on the manager's device)
        pair that makes a llava model of seeded decoder weights)."""
        return self.add(self._build(name, cfg, params, tokenizer, dtype,
                                    **kw))

    def _build(self, name, cfg, params, tokenizer, dtype, **kw):
        if not self.serve_models:
            raise ApiError(503, "this instance is a model store; it serves "
                                "pulls, not inference")
        engine_dtype = dtype or resolve_engine_dtype(cfg, self.device)
        lm = LoadedModel(name, cfg,
                         apply_engine_dtype(params, engine_dtype,
                                            self.device),
                         tokenizer, device=self.device, **kw)
        lm.serving_dtype = engine_dtype
        return lm

    def add(self, lm: LoadedModel) -> LoadedModel:
        if lm.device != self.device:
            raise ValueError(f"model on {lm.device}, manager on "
                             f"{self.device}")
        with self._lock:
            old = self._models.get(lm.name)
            self._models[lm.name] = lm
            if self.draining:
                lm.begin_drain()
        if old is not None and old is not lm:
            old.unload()
        return lm

    def resident(self) -> List[LoadedModel]:
        with self._lock:
            return list(self._models.values())

    # -- lifecycle -------------------------------------------------------
    def broken(self) -> bool:
        """True when a resident model's engine failed for good (its
        scheduler went broken): the liveness and readiness probes fail."""
        return any(lm.scheduler.broken is not None
                   for lm in self.resident())

    def begin_drain(self):
        """Enter draining: readiness fails, every resident model's
        scheduler sheds new work (503 + Retry-After), running streams keep
        generating. Idempotent."""
        with self._lock:
            already, self.draining = self.draining, True
            models = list(self._models.values())
        if not already:
            FLIGHT.record("drain", phase="manager",
                          models=[lm.name for lm in models])
        for lm in models:
            lm.begin_drain()

    def drain(self, timeout_s: Optional[float] = None) -> int:
        """Graceful drain for SIGTERM: begin_drain(), then let every
        resident model's streams finish within ``timeout_s`` in all
        (default TPU_DRAIN_TIMEOUT_S) before the stragglers are ended.
        Returns the stragglers."""
        from ..runtime.scheduler import drain_timeout_s
        self.begin_drain()
        if timeout_s is None:
            timeout_s = drain_timeout_s()
        deadline = time.monotonic() + max(0.0, timeout_s)
        return sum(lm.drain(max(0.0, deadline - time.monotonic()))
                   for lm in self.resident())

    def track(self, delta: int):
        with self._inflight_cv:
            self._inflight += delta
            self._inflight_cv.notify_all()

    def wait_idle(self, timeout_s: float) -> bool:
        """Wait until no generation handler runs (each has written its
        last frame), at most ``timeout_s``; False if some still run."""
        with self._inflight_cv:
            return self._inflight_cv.wait_for(lambda: self._inflight == 0,
                                              timeout=timeout_s)

    def _find(self, name: str) -> Optional[LoadedModel]:
        with self._lock:
            lm = self._models.get(name)
            if lm is None and name.strip():
                lm = self._models.get(ModelName.parse(name).short)
            return lm or self._models.get(name.split(":")[0])

    # -- the blob store --------------------------------------------------
    def require_store(self) -> ModelStore:
        if self.store is None:
            raise ApiError(400, "this server has no model store")
        return self.store

    @staticmethod
    def _read_layer_text(layers: Dict[str, str], mt: str) -> Optional[str]:
        path = layers.get(mt)
        if not path:
            return None
        try:
            with open(path, "r", errors="replace") as f:
                return f.read()
        except OSError:
            return None

    def load(self, ref: str) -> LoadedModel:
        """Make the store's model ``ref`` resident, as the JAX manager's
        ``load`` does: resolve its layers, read the GGUF header once
        (refusing what the port cannot serve), resolve the weight dtype
        per model when none was given, parse and transcode (through the
        cache) before tearing the old model down, merge an ``ADAPTER``
        layer into the weights before they are quantized (a bad adapter
        is a 400, "adapter: ..."), load a ``PROJECTOR`` layer's vision
        tower (bf16 on the card, f32 on the CPU), apply the template,
        system and params layers, and build the engine at the serving
        defaults. One store-loaded model is resident at a time."""
        if not self.serve_models:
            raise ApiError(503, "this instance is a model store; it serves "
                                "pulls, not inference")
        store = self.store
        name = ModelName.parse(ref)
        if store is None:
            raise ApiError(404, f"model {name.short!r} not found")
        with self._load_lock:
            with self._lock:
                lm = self._models.get(name.short)
            if lm is not None and lm.scheduler.broken is None:
                return lm
            layers = store.model_layers(name)  # raises if absent
            gguf_path = layers.get(MT_MODEL)
            if not gguf_path:
                raise ApiError(500, f"model {name.short} has no model layer")
            digest = store.model_digest(name) or ""
            with GGUFFile(gguf_path) as hdr:
                if is_encoder_arch(hdr.arch):
                    # an embedding model: the encoder's f32 weights and
                    # tokenizer, no engine (read uncached, as the JAX
                    # manager reads them)
                    ecfg2 = encoder_config_from_gguf(hdr)
                    enc = (ecfg2, load_encoder_params(hdr, ecfg2),
                           {k: v for k, v in hdr.metadata.items()
                            if k.startswith("tokenizer.")})
                else:
                    enc = None
                    try:
                        hcfg = check_supported(config_from_gguf(hdr))
                    except NotImplementedError as e:
                        raise ApiError(501, f"model {name.short}: {e}"
                                       ) from e
            if enc is not None:
                ecfg2, eparams, tok_md = enc
                self._unload_store_models()
                lm = EmbeddingModel(
                    name.short, ecfg2,
                    params_from_numpy(eparams, self.device),
                    Tokenizer.from_gguf_metadata(tok_md), digest=digest,
                    device=self.device)
                del eparams, enc
                return self._install(lm)
            engine_dtype = self.engine_dtype
            if engine_dtype is None:
                engine_dtype = resolve_engine_dtype(hcfg, self.device)
                print(f"serving dtype for {name.short}: {engine_dtype} "
                      f"({hcfg.n_params / 1e9:.2f}B params, auto)",
                      file=sys.stderr)
            dt = transcode_dtype(engine_dtype, self.device)
            cfg, params, tok_md = transcode_load(
                gguf_path, cache_dir=self.cache_dir, dtype=dt,
                digest=digest.replace("sha256:", "")[:24] or None)
            adapter_path = layers.get(MT_ADAPTER)
            if adapter_path:
                # W += (alpha/r)·BA on the host, before quantization
                try:
                    params = apply_lora(params, cfg, adapter_path)
                except ValueError as e:
                    raise ApiError(400, f"adapter: {e}") from e
            tokenizer = Tokenizer.from_gguf_metadata(tok_md)
            template = self._read_layer_text(layers, MT_TEMPLATE)
            system = self._read_layer_text(layers, MT_SYSTEM)
            params_raw = self._read_layer_text(layers, MT_PARAMS)
            default_params = json.loads(params_raw) if params_raw else {}
            self._unload_store_models()
            vision = None
            proj_path = layers.get(MT_PROJECTOR)
            if proj_path:
                # a llava mmproj layer: the CLIP tower and MLP projector
                with GGUFFile(proj_path) as vf:
                    vcfg = vision_config_from_gguf(vf)
                    vision = (vcfg, params_from_numpy(
                        load_vision_params(vf, vcfg, dtype=dt),
                        self.device))
            ecfg = self.ecfg or EngineConfig(max_seq_len=min(
                cfg.max_seq_len, int(default_params.get("num_ctx", 4096))))
            lm = self._build(
                name.short, cfg, params_from_numpy(params, self.device),
                tokenizer, engine_dtype, template=template, system=system,
                default_params=default_params,
                ecfg=resolve_serving_defaults(ecfg, cfg, self.device),
                vision=vision)
            del params
            lm.digest = digest
            return self._install(lm)

    def _unload_store_models(self):
        """Unload every store-loaded model: one is resident at a time."""
        with self._lock:
            old = [m for m in self._models.values() if m.digest is not None]
            for m in old:
                del self._models[m.name]
                self._expires.pop(m.name, None)
        for m in old:
            m.unload()

    def _install(self, lm):
        """Make the store-loaded ``lm`` resident at the default keep-alive
        deadline."""
        with self._lock:
            self._models[lm.name] = lm
            if self.draining:
                lm.begin_drain()
            ka = self.default_keep_alive
            self._expires[lm.name] = (None if ka is None
                                      else self._clock() + ka)
        return lm

    def require_loaded(self, name: str, keep_alive=None) -> LoadedModel:
        """The model ``name``, loaded from the store if it is not resident
        (404 if it is in neither). A ``keep_alive`` that
        :func:`parse_keep_alive` refuses is a 400; a valid one (else the
        default) arms a store-loaded model's idle deadline."""
        ka = self.keep_alive_s(keep_alive)
        for _ in range(3):
            lm = self._find(name)
            if lm is None or (lm.scheduler.broken is not None
                              and lm.digest is not None):
                # a broken store model is torn down and loaded afresh
                try:
                    lm = self.load(name)
                except RegistryError as e:
                    raise ApiError(404, str(e)) from e
            # arm the deadline under the lock the reaper takes: if the
            # reaper unloaded the model in between, load it again
            if self.touch(lm, ka):
                return lm
        raise ApiError(503, f"model {name!r} kept unloading during load "
                            f"(keep_alive too short?)")

    def keep_alive_s(self, keep_alive=None) -> Optional[float]:
        """A request's ``keep_alive`` in seconds (None: forever), the
        default when it names none; 400 for a value the reference
        refuses."""
        if keep_alive is None:
            return self.default_keep_alive
        try:
            return parse_keep_alive(keep_alive)
        except ValueError:
            raise ApiError(400, f"invalid keep_alive "
                                f"{keep_alive!r}") from None

    def touch(self, lm: LoadedModel, keep_alive: Optional[float]) -> bool:
        """Re-arm ``lm``'s idle deadline at ``keep_alive`` seconds from now
        (None: keep forever); in-process models have none. False when
        ``lm`` is no longer resident."""
        with self._lock:
            if self._models.get(lm.name) is not lm:
                return False
            if lm.name in self._expires:
                self._expires[lm.name] = (None if keep_alive is None
                                          else self._clock() + keep_alive)
            return True

    def reap_idle(self) -> List[str]:
        """One pass of the keep-alive reaper: unload every store-loaded
        model whose deadline has passed and that has no request waiting
        or running. Returns the names unloaded."""
        now = self._clock()
        gone = []
        with self._lock:
            for name, exp in list(self._expires.items()):
                lm = self._models.get(name)
                if (lm is None or exp is None or now < exp
                        or lm.scheduler.has_pending):
                    continue
                del self._models[name]
                del self._expires[name]
                gone.append(lm)
        for lm in gone:
            lm.unload()   # outside the lock: shutdown joins the loop
        return [lm.name for lm in gone]

    def _reap_loop(self, every_s: float):
        while not self._reaper_stop.wait(every_s):
            self.reap_idle()

    def stop(self, name: str) -> None:
        """keep_alive 0 with an empty prompt (``ollama stop``): take the
        model out of the manager, so that later requests for it are 404s
        (or, for a store model, load it again), and unload it once the
        requests it is serving have finished (a name that is not resident
        is left as it is)."""
        lm = self._find(name)
        if lm is None:
            return
        with self._lock:
            if self._models.get(lm.name) is lm:
                del self._models[lm.name]
                self._expires.pop(lm.name, None)
        if lm.scheduler.has_pending:
            threading.Thread(target=lm.unload_when_idle, daemon=True,
                             name=f"unload-{lm.name}").start()
        else:
            lm.unload()

    # -- model management ------------------------------------------------
    def model_details(self, name: ModelName) -> Dict:
        out = {"format": "gguf", "family": "", "families": None,
               "parameter_size": "", "quantization_level": ""}
        try:
            path = self.require_store().model_layers(name).get(MT_MODEL)
            if path:
                with GGUFFile(path) as f:
                    out["family"] = f.arch
                    out["families"] = [f.arch]
                    cnt = f.metadata.get("general.parameter_count")
                    if cnt:
                        out["parameter_size"] = _fmt_params(int(cnt))
                    ft = f.metadata.get("general.file_type")
                    if ft is not None:
                        out["quantization_level"] = _FILE_TYPES.get(
                            ft, str(ft))
        except (RegistryError, OSError, ValueError):
            pass
        return out

    def list_models(self) -> List[Dict]:
        """The store's models as the JAX manager lists them, then the
        resident in-process models."""
        models = []
        for m in (self.store.list_models() if self.store else []):
            name: ModelName = m["name"]
            digest = (m["manifest"].get("config", {}) or {}).get("digest", "")
            models.append({
                "name": name.short, "model": name.short,
                "modified_at": datetime.fromtimestamp(
                    m["modified_at"], timezone.utc).isoformat(),
                "size": m["size"],
                "digest": digest.replace("sha256:", ""),
                "details": self.model_details(name),
            })
        with self._lock:
            own = [lm for lm in self._models.values()
                   if lm.digest is None]
        models += [{"name": lm.name, "model": lm.name,
                    "modified_at": datetime.fromtimestamp(
                        lm.loaded_at, timezone.utc).isoformat(),
                    "size": 0, "digest": "",
                    "details": {"family": lm.cfg.arch, "format": "torch",
                                "parameter_size":
                                    f"{lm.cfg.n_params / 1e9:.1f}B",
                                "quantization_level":
                                    lm.serving_dtype or ""}}
                   for lm in own]
        return models

    def ps(self) -> List[Dict]:
        """The resident models, with the JAX manager's core keys: the
        serving dtype, decode chunk and cache kind it resolved, the
        keep-alive deadline, the bytes the process holds on the card
        (``size_vram``), the prefix cache's token counts
        (``prefix_cache``), the failure counters (``failures``), and the
        blocks the operator's drain-first shrink and autoscaler read:
        ``admission`` (queue depth and backlog by class, the knobs),
        ``lifecycle`` (serving/draining/broken, active streams, queued,
        restarts, replays, the watchdog's budget) and ``utilization``
        (MFU against the card's peak, goodput, occupancy, the wall-clock
        breakdown). ``kernel_launches`` counts every kernel launch of
        this process so far (``ops/cuda_build.launches``)."""
        with self._lock:
            models = [(lm, self._expires.get(lm.name))
                      for lm in self._models.values()]
        vram = (torch.cuda.memory_allocated(self.device)
                if self.device is not None and self.device.type == "cuda"
                else 0)
        out = []
        for lm, exp in models:
            # an embedding model has no engine: no decode chunk, no cache
            eng = getattr(lm, "engine", None)
            if exp is None:
                expires = "0001-01-01T00:00:00Z"  # keep forever
            else:
                wall = time.time() + (exp - self._clock())
                expires = datetime.fromtimestamp(
                    wall, timezone.utc).isoformat()
            out.append({
                "name": lm.name, "model": lm.name,
                "size": int(lm.cfg.n_params * 2),
                "digest": (lm.digest or "").replace("sha256:", ""),
                "details": {"format": "gguf", "family": lm.cfg.arch,
                            "parameter_size": _fmt_params(lm.cfg.n_params),
                            "serving_dtype": lm.serving_dtype,
                            "decode_chunk": (eng.ecfg.decode_chunk
                                             if eng is not None else None),
                            "paged": bool(eng is not None and eng.paged)},
                "expires_at": expires,
                "size_vram": vram,
                "kernel_launches": dict(cuda_build.launches),
                # the model's lifetime prefix-cache token counts and the
                # pages its radix tree holds, as the JAX server reports
                "prefix_cache": {
                    "enabled": bool(eng is not None and eng.radix_enabled),
                    "hit_tokens": lm.scheduler.prefix_hit_tokens,
                    "miss_tokens": lm.scheduler.prefix_miss_tokens,
                    "radix_pages": eng.radix_pages if eng is not None
                    else 0},
                "failures": {
                    "broken": lm.scheduler.broken is not None,
                    "engine_restarts": lm.scheduler.n_restarts,
                    "request_timeouts": int(METRICS.get(
                        "tpu_model_request_timeouts_total")),
                    "requests_shed": int(METRICS.get(
                        "tpu_model_requests_shed_total")),
                },
                "admission": lm.scheduler.admission_stats(),
                "lifecycle": lm.scheduler.lifecycle_stats(),
                "utilization": lm.scheduler.utilization_stats(),
            })
        return out

    def show(self, ref: str) -> Dict:
        """The JAX manager's ``show``: the model's Modelfile, parameters,
        template, system, license, details, GGUF metadata (arrays of 64
        items or more left out) and capabilities."""
        store = self.require_store()
        name = ModelName.parse(ref)
        if store.read_manifest(name) is None:
            raise ApiError(404, f"model {name.short!r} not found")
        layers = store.model_layers(name)
        template = self._read_layer_text(layers, MT_TEMPLATE) or ""
        system = self._read_layer_text(layers, MT_SYSTEM) or ""
        params_raw = self._read_layer_text(layers, MT_PARAMS)
        lic = self._read_layer_text(layers, MT_LICENSE) or ""
        mf = Modelfile(from_=name.short, template=template or None,
                       system=system or None,
                       adapter=layers.get(MT_ADAPTER))
        parameters = ""
        if params_raw:
            try:
                pj = json.loads(params_raw)
                mf.parameters = pj
                parameters = "\n".join(
                    f"{k:30s} {item}" for k, v in sorted(pj.items())
                    for item in (v if isinstance(v, list) else [v]))
            except json.JSONDecodeError:
                pass
        info = {}
        path = layers.get(MT_MODEL)
        if path:
            try:
                with GGUFFile(path) as f:
                    info = {k: v for k, v in f.metadata.items()
                            if not isinstance(v, list) or len(v) < 64}
            except (OSError, ValueError):
                pass
        capabilities = ["completion"]
        if MT_PROJECTOR in layers:
            capabilities.append("vision")
        return {"modelfile": mf.render(), "parameters": parameters,
                "template": template, "system": system, "license": lic,
                "details": self.model_details(name), "model_info": info,
                "capabilities": capabilities}

    def delete(self, ref: str):
        """Remove ``ref``'s manifest (and the blobs no manifest still
        references) from the store, and unload it if it is resident."""
        name = ModelName.parse(ref)
        if not self.require_store().delete_model(name):
            raise ApiError(404, f"model {name.short!r} not found")
        with self._lock:
            lm = self._models.get(name.short)
            if lm is not None and lm.digest is not None:
                del self._models[name.short]
                self._expires.pop(name.short, None)
            else:
                lm = None
        if lm is not None:
            lm.unload()

    def pull(self, ref: str, progress=None) -> ModelName:
        """Pull ``ref`` from its registry into the store (idempotent;
        resumes); ``progress(status, completed, total, digest=None)``."""
        self.require_store()
        return self.client.pull(ref, progress)

    def push(self, ref: str, progress=None) -> ModelName:
        """Push the store's model ``ref`` to its registry; ``progress`` as
        for :meth:`pull`."""
        self.require_store()
        return self.client.push(ref, progress)

    def copy(self, src: str, dst: str):
        """``dst`` names the manifest of the store model ``src``."""
        store = self.require_store()
        sname, dname = ModelName.parse(src), ModelName.parse(dst)
        manifest = store.read_manifest(sname)
        if manifest is None:
            raise ApiError(404, f"model {sname.short!r} not found")
        store.write_manifest(dname, manifest)

    def create(self, ref: str, modelfile_text: str, progress=None) -> None:
        """A store model ``ref`` from a Modelfile, as the JAX manager
        creates it. FROM ``@<digest>`` takes an uploaded blob as the model
        layer; FROM a store model inherits each of its layers that the
        Modelfile does not replace (its parameters merged under the
        Modelfile's); FROM anything else is a GGUF path on the server's
        filesystem, copied into the store. TEMPLATE, SYSTEM, PARAMETER,
        LICENSE and ADAPTER lines add their layers (an ADAPTER is a path on
        the server, merged into the weights when the model loads).
        ``progress(status, ...)``."""
        store = self.require_store()
        mf = parse_modelfile(modelfile_text)
        if not mf.from_:
            raise ApiError(400, "Modelfile needs a FROM line")
        name = ModelName.parse(ref)
        layers = []
        base_params: Dict = {}
        if mf.from_.startswith("@"):
            digest = mf.from_[1:]
            if not (valid_blob_digest(digest) and store.has_blob(digest)):
                raise ApiError(400, f"FROM {mf.from_!r}: blob not "
                                    "uploaded (POST /api/blobs/<digest>)")
            layers.append({"mediaType": MT_MODEL, "digest": digest,
                           "size": os.path.getsize(store.blob_path(digest))})
        elif (base := store.read_manifest(
                ModelName.parse(mf.from_))) is not None:
            overridden = {mt for mt, v in ((MT_TEMPLATE, mf.template),
                                           (MT_SYSTEM, mf.system),
                                           (MT_LICENSE, mf.license),
                                           (MT_ADAPTER, mf.adapter)) if v}
            for layer in base.get("layers", []):
                mt = layer["mediaType"]
                if mt == MT_PARAMS:
                    try:
                        with open(store.blob_path(layer["digest"])) as f:
                            base_params = json.load(f)
                    except (OSError, json.JSONDecodeError):
                        pass
                    continue    # emitted below, merged
                if mt not in overridden:
                    layers.append(layer)
        else:
            if not os.path.exists(mf.from_):
                raise ApiError(400, f"FROM {mf.from_!r}: not a local model "
                                    "or file")
            if progress:
                progress("importing model blob", 0, 0)
            layers.append({"mediaType": MT_MODEL,
                           **store.add_blob_file(mf.from_)})
        if mf.template:
            layers.append({"mediaType": MT_TEMPLATE,
                           **store.add_blob(mf.template.encode())})
        if mf.system:
            layers.append({"mediaType": MT_SYSTEM,
                           **store.add_blob(mf.system.encode())})
        if mf.parameters or base_params:
            mf.parameters = {**base_params, **(mf.parameters or {})}
            layers.append({"mediaType": MT_PARAMS,
                           **store.add_blob(params_json(mf).encode())})
        if mf.license:
            layers.append({"mediaType": MT_LICENSE,
                           **store.add_blob(mf.license.encode())})
        if mf.adapter:
            if not os.path.exists(mf.adapter):
                raise ApiError(400, f"ADAPTER {mf.adapter!r}: no such file")
            if progress:
                progress("importing adapter", 0, 0)
            layers.append({"mediaType": MT_ADAPTER,
                           **store.add_blob_file(mf.adapter)})
        config = store.add_blob(json.dumps({"model_format": "gguf"}).encode())
        store.write_manifest(name, {
            "schemaVersion": 2,
            "mediaType": "application/vnd.docker.distribution.manifest"
                         ".v2+json",
            "config": {"mediaType": "application/vnd.docker.container"
                                    ".image.v1+json", **config},
            "layers": layers})
        if progress:
            progress("success", 0, 0)

    def shutdown(self):
        self._reaper_stop.set()
        reaper = getattr(self, "_reaper", None)
        if reaper is not None and reaper is not threading.current_thread():
            # joined, as the scheduler joins its threads, so that no daemon
            # thread is left to wake into the interpreter's exit
            reaper.join(timeout=10)
        with self._lock:
            models = list(self._models.values())
            self._models.clear()
            self._expires.clear()
        for lm in models:
            lm.unload()


class Handler(BaseHTTPRequestHandler):
    manager: ModelManager = None  # set by serve()
    protocol_version = "HTTP/1.1"
    server_version = "torch-ollama/" + __version__

    def log_message(self, fmt, *args):  # quiet by default
        pass

    def _json_body(self) -> Dict:
        n = int(self.headers.get("Content-Length") or 0)
        if n == 0:
            return {}
        try:
            return json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as e:
            raise ApiError(400, f"invalid json: {e}") from e

    def _send_json(self, obj, status=200,
                   headers: Optional[Dict[str, str]] = None):
        self._send_body(json.dumps(obj).encode(), "application/json",
                        status, headers)

    def _send_text(self, text: str, status=200,
                   ctype="text/plain; charset=utf-8"):
        self._send_body(text.encode(), ctype, status)

    def _send_body(self, body: bytes, ctype: str, status: int,
                   headers: Optional[Dict[str, str]] = None):
        self.send_response(status)
        self.send_header("Content-Type", ctype)
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def _start_stream(self, ctype: str = "application/x-ndjson"):
        self.send_response(200)
        self.send_header("Content-Type", ctype)
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self._streaming = True
        self._stream_ctype = ctype

    def _chunk(self, data: bytes):
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _end_stream(self):
        self._chunk(b"")
        self._streaming = False

    def _stream_json(self, obj):
        self._chunk(json.dumps(obj).encode() + b"\n")

    @staticmethod
    def _sse(obj) -> bytes:
        return b"data: " + json.dumps(obj).encode() + b"\n\n"

    def _send_error(self, message: str, status: int,
                    headers: Optional[Dict[str, str]] = None):
        """An error that is safe before and after a stream started: once
        the chunked headers are out, it becomes the stream's last frame
        (on an SSE stream an error event and ``[DONE]``, which OpenAI
        clients wait for)."""
        if getattr(self, "_streaming", False):
            try:
                if getattr(self, "_stream_ctype", "") == "text/event-stream":
                    self._chunk(self._sse({"error": {
                        "message": message, "type": "server_error"}}))
                    self._chunk(b"data: [DONE]\n\n")
                else:
                    self._stream_json({"error": message})
                self._end_stream()
            except (BrokenPipeError, ConnectionResetError):
                pass
        else:
            self._send_json({"error": message}, status, headers=headers)

    @staticmethod
    def _pull_first(gen):
        """Pull the first (piece, final) pair before the caller commits
        200 and the chunked headers, so that a failure before the first
        token is still a real HTTP status; returns an iterator that
        replays it."""
        it = iter(gen)
        try:
            first = next(it)
        except StopIteration:
            return iter(())
        return itertools.chain([first], it)

    def _coalescer(self, pre: bytes, mid: Optional[bytes], suf: bytes,
                   options: Optional[Dict], trace=None) -> _StreamCoalescer:
        """A frame coalescer over this response's chunked stream. A frame
        is ``pre + timestamp + mid + json(text) + suf`` (NDJSON) or
        ``pre + json(text) + suf`` when ``mid`` is None (SSE chunks carry
        no timestamp); the fragments reproduce json.dumps of the whole
        frame dict byte for byte."""
        n, sec = resolve_stream_flush(options)
        buf = bytearray()

        def make(text: str) -> bytearray:
            buf.clear()
            buf.extend(pre)
            if mid is not None:
                # an ISO-8601 UTC stamp is plain ASCII with no JSON
                # escapes, so splicing it raw equals json.dumps output
                buf.extend(_now_iso().encode())
                buf.extend(mid)
            buf.extend(json.dumps(text).encode())
            buf.extend(suf)
            return buf

        return _StreamCoalescer(self._chunk, make, n, sec, trace=trace)

    # -- probes and introspection -----------------------------------------
    def _query(self) -> Dict[str, str]:
        """The last value of each key of the request's query string."""
        from urllib.parse import parse_qs
        qs = parse_qs(self.path.partition("?")[2])
        return {k: v[-1] for k, v in qs.items()}

    def _query_int(self, key: str, default: int) -> int:
        try:
            return int(self._query().get(key, default))
        except ValueError:
            return default

    def _probe(self, path: str):
        """/livez and /readyz: 503 "engine failed" when a resident model's
        scheduler is broken (the kubelet then restarts the pod: a sticky
        device error is not recovered in-process); /readyz 503
        "draining" while draining, /livez 200 then."""
        if self.manager.broken():
            self._send_text("engine failed", status=503)
        elif path == "/readyz" and self.manager.draining:
            self._send_text("draining", status=503)
        else:
            self._send_text("ok")

    def _debug_trace(self):
        """A recent request's span timeline; with no id, the ids the
        tracer still holds (newest last)."""
        rid = self._query().get("id")
        if rid is None:
            self._send_json({"ids": TRACER.ids()})
            return
        tr = TRACER.get(rid)
        if tr is None:
            self._send_json({"error": f"no trace for id {rid!r} "
                             "(evicted, or TPU_TRACE=0)"}, 404)
            return
        self._send_json(tr.to_dict())

    def _debug_events(self):
        """The flight recorder's ring, oldest first: ?kind=K keeps one
        event type (before the trim), ?last=N the newest N."""
        events = FLIGHT.snapshot()
        kind = self._query().get("kind", "")
        if kind:
            events = [e for e in events if e.get("kind") == kind]
        last = self._query_int("last", 0)
        if last > 0:
            events = events[-last:]
        self._send_json({"events": events, "dumps": FLIGHT.dumps})

    def _debug_utilization(self):
        """A resident model's (?model=, else the first) per-second
        utilization ring (?last=N seconds, 60) and its windowed
        snapshot."""
        name = self._query().get("model")
        lm = (self.manager._find(name) if name
              else next(iter(self.manager.resident()), None))
        if lm is None:
            self._send_json({"error": "no model loaded"}, 404)
            return
        acct = getattr(lm.scheduler, "acct", None)
        if acct is None or not acct.enabled:
            self._send_json({"enabled": False, "error": "accounting "
                             "disabled (TPU_ACCOUNTING=0)"})
            return
        last = max(1, min(self._query_int("last", 60), 600))
        self._send_json({"model": lm.name,
                         "snapshot": lm.scheduler.utilization_stats(),
                         "ring": acct.ring(last=last)})

    def do_GET(self):
        try:
            path = self.path.split("?")[0]
            if path == "/":
                self._send_text("Ollama is running")
            elif path == "/healthz":
                self._send_text("ok")
            elif path in ("/livez", "/readyz"):
                self._probe(path)
            elif path == "/metrics":
                self._send_text(METRICS.render(),
                                ctype="text/plain; version=0.0.4")
            elif path == "/debug/trace":
                self._debug_trace()
            elif path == "/debug/events":
                self._debug_events()
            elif path == "/debug/utilization":
                self._debug_utilization()
            elif path == "/api/version":
                self._send_json({"version": __version__})
            elif path == "/api/tags":
                self._send_json({"models": self.manager.list_models()})
            elif path == "/api/ps":
                self._send_json({"models": self.manager.ps()})
            elif path == "/v1/models":
                self._send_json({"object": "list", "data": [
                    {"id": m["name"], "object": "model", "created": 0,
                     "owned_by": "library"}
                    for m in self.manager.list_models()]})
            else:
                self._send_json({"error": "not found"}, 404)
        except ApiError as e:
            self._send_json({"error": str(e)}, e.status)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — the request boundary
            self._send_json({"error": f"internal: {e}"}, 500)

    def do_HEAD(self):
        path = self.path.split("?")[0]
        if path.startswith("/api/blobs/"):
            # `ollama create` asks before uploading (200: skip the POST).
            # The digest is checked before it reaches a path: an
            # unchecked one would answer for any file on the host.
            digest = path[len("/api/blobs/"):]
            store = self.manager.store
            ok = (valid_blob_digest(digest) and store is not None
                  and store.has_blob(digest))
        else:
            ok = path == "/"
        self.send_response(200 if ok else 404)
        self.send_header("Content-Length", "0")
        self.end_headers()

    def do_DELETE(self):
        try:
            if self.path.split("?")[0] == "/api/delete":
                self._api_delete(self._json_body())
            else:
                self._send_json({"error": "not found"}, 404)
        except ApiError as e:
            self._send_json({"error": str(e)}, e.status)
        except Exception as e:  # noqa: BLE001 — the request boundary
            self._send_json({"error": f"internal: {e}"}, 500)

    _GENERATION = ("/api/generate", "/api/chat", "/v1/chat/completions",
                   "/v1/completions", "/api/embed", "/api/embeddings",
                   "/v1/embeddings")

    def do_POST(self):
        path = self.path.split("?")[0]
        if path.startswith("/api/blobs/"):
            self._api_blob_upload(path[len("/api/blobs/"):])
            return
        tracked = path in self._GENERATION
        if tracked:
            self.manager.track(1)
        try:
            body = self._json_body()
            route = {"/api/generate": self._api_generate,
                     "/api/chat": self._api_chat,
                     "/api/pull": self._api_pull,
                     "/api/push": self._api_push,
                     "/api/create": self._api_create,
                     "/api/copy": self._api_copy,
                     "/api/show": self._api_show,
                     "/api/delete": self._api_delete,
                     "/api/drain": self._api_drain,
                     "/api/embed": self._api_embed,
                     "/api/embeddings": self._api_embeddings,
                     "/v1/chat/completions": self._oai_chat,
                     "/v1/completions": self._oai_completions,
                     "/v1/embeddings": self._oai_embeddings,
                     }.get(path)
            if route is None:
                raise ApiError(404, "not found")
            route(body)
        except ApiError as e:
            self._send_error(str(e), e.status)
        except BadRequest as e:
            self._send_error(str(e), 400)
        except DeadlineExceeded as e:
            # shed while queued: the caller got nothing and should retry
            # (503 is what load balancers key backpressure on); cut off
            # before a stream started: 504
            if e.while_queued:
                self._send_error(str(e), 503, headers={
                    "Retry-After": str(int(e.retry_after_s))})
            else:
                self._send_error(str(e), 504)
        except TenantRateLimited as e:
            # this tenant is over its share, everyone else is fine
            self._send_error(str(e), 429, headers={
                "Retry-After": str(int(e.retry_after_s))})
        except SchedulerBusy as e:
            # queue full, draining, or a TTFT-SLO early reject: each with
            # a computed Retry-After
            self._send_error(str(e), 503, headers={
                "Retry-After": str(int(e.retry_after_s))})
        except (SchedulerBroken, RegistryError) as e:
            self._send_error(str(e), 500)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — the request boundary
            self._send_error(f"internal: {e}", 500)
        finally:
            if tracked:
                self.manager.track(-1)

    def _api_drain(self, body: Dict):
        """Operator-initiated graceful drain (the drain-first shrink):
        /readyz answers 503, new work is shed, running streams finish.
        Idempotent: the operator posts again until /api/ps shows no
        active work."""
        self.manager.begin_drain()
        models = self.manager.resident()
        self._send_json({
            "status": "draining",
            "active_streams": sum(lm.scheduler.n_active for lm in models),
            "queued": sum(lm.scheduler.qsize for lm in models),
        })

    def _inject_tenant(self, options: Optional[Dict]) -> Optional[Dict]:
        """The fair-queuing tenant from the transport headers when the
        options name none: ``X-Tenant`` as it is, else a stable hash of
        the API key (``X-API-Key`` / ``Authorization``)."""
        o = dict(options or {})
        if not o.get("tenant"):
            t = self.headers.get("X-Tenant")
            if not t:
                key = (self.headers.get("X-API-Key")
                       or self.headers.get("Authorization"))
                t = tenant_from_key(key) if key else None
            if t:
                o["tenant"] = t
        return o or None

    @staticmethod
    def _model_arg(body: Dict) -> str:
        model = body.get("model") or body.get("name")
        if not model:
            raise ApiError(400, "missing 'model'")
        return model

    def _api_pull(self, body: Dict):
        model = self._model_arg(body)
        self.manager.require_store()
        if body.get("stream", True):
            self._progress_stream(lambda p: self.manager.pull(model, p))
        else:
            self.manager.pull(model)
            self._send_json({"status": "success"})

    def _progress_stream(self, run):
        """``run(progress)`` with its progress streamed as NDJSON lines; a
        RegistryError or ApiError becomes the stream's last line."""
        self._start_stream()

        def progress(status, completed=0, total=0, digest=None):
            msg = {"status": status}
            if total:
                msg["total"] = total
                msg["completed"] = completed
            if digest:
                msg["digest"] = digest
            self._stream_json(msg)

        try:
            run(progress)
        except (RegistryError, ApiError) as e:
            self._stream_json({"error": str(e)})
        self._end_stream()

    def _api_push(self, body: Dict):
        model = self._model_arg(body)
        self.manager.require_store()
        if body.get("stream", True):
            self._progress_stream(lambda p: self.manager.push(model, p))
        else:
            self.manager.push(model)
            self._send_json({"status": "success"})

    def _api_blob_upload(self, digest: str):
        """POST /api/blobs/sha256:<hex>: the raw body is the blob (the CLI
        uploads a local GGUF here before /api/create names it). An error
        answered without reading the declared body would leave the blob's
        bytes on the keep-alive socket, to be parsed as the next request,
        so every error closes the connection."""
        try:
            length = int(self.headers.get("Content-Length", "0"))
            if length <= 0:
                self.close_connection = True
                self._send_error("missing blob body", 400)
                return
            if not valid_blob_digest(digest):
                self.close_connection = True
                self._send_error(f"unsupported digest {digest!r}", 400)
                return
            self.manager.require_store().put_blob_stream(digest, self.rfile,
                                                         length)
            self.send_response(201)
            self.send_header("Content-Length", "0")
            self.end_headers()
        except (RegistryError, ApiError) as e:
            self.close_connection = True
            self._send_error(str(e), getattr(e, "status", 400))
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — the request boundary
            self.close_connection = True
            self._send_error(f"internal: {e}", 500)

    def _api_create(self, body: Dict):
        model = self._model_arg(body)
        modelfile_text = body.get("modelfile", "")
        if not modelfile_text and body.get("files"):
            # {"files": {"x.gguf": "sha256:..."}} of uploaded blobs
            files = body["files"]
            if len(files) != 1:
                raise ApiError(400, "multi-file create is not supported "
                                    "(one GGUF per model)")
            lines = [f"FROM @{next(iter(files.values()))}"]
            if body.get("template"):
                lines.append('TEMPLATE """' + body["template"] + '"""')
            if body.get("system"):
                lines.append('SYSTEM """' + body["system"] + '"""')
            for k, v in (body.get("parameters") or {}).items():
                lines.extend(f"PARAMETER {k} {item}"
                             for item in (v if isinstance(v, list) else [v]))
            modelfile_text = "\n".join(lines)
        if not modelfile_text and body.get("from"):
            modelfile_text = f"FROM {body['from']}"
        if body.get("stream", True):
            self._progress_stream(lambda p: self.manager.create(
                model, modelfile_text, p))
        else:
            self.manager.create(model, modelfile_text)
            self._send_json({"status": "success"})

    def _api_copy(self, body: Dict):
        src, dst = body.get("source"), body.get("destination")
        if not src or not dst:
            raise ApiError(400, "need 'source' and 'destination'")
        self.manager.copy(src, dst)
        self._send_json({})

    def _api_show(self, body: Dict):
        self._send_json(self.manager.show(self._model_arg(body)))

    # -- embeddings ----------------------------------------------------------
    def _embed_input(self, body: Dict):
        """The model (loaded with the request's ``keep_alive``) and the
        embeddings of ``input``, a string or a list of strings."""
        lm = self.manager.require_loaded(self._model_arg(body),
                                         keep_alive=body.get("keep_alive"))
        inp = body.get("input", "")
        texts = [inp] if isinstance(inp, str) else list(inp)
        return lm.embed(texts)

    def _api_embeddings(self, body: Dict):
        lm = self.manager.require_loaded(self._model_arg(body),
                                         keep_alive=body.get("keep_alive"))
        emb = lm.embed([body.get("prompt", "")])[0]
        self._send_json({"embedding": [float(x) for x in emb]})

    def _api_embed(self, body: Dict):
        embs = self._embed_input(body)
        self._send_json({
            "model": body.get("model"), "object": "list",
            "embeddings": [[float(x) for x in e] for e in embs]})

    def _oai_embeddings(self, body: Dict):
        embs = self._embed_input(body)
        self._send_json({
            "object": "list", "model": body.get("model"),
            "data": [{"object": "embedding", "index": i,
                      "embedding": [float(x) for x in e]}
                     for i, e in enumerate(embs)],
            "usage": {"prompt_tokens": 0, "total_tokens": 0}})

    def _api_delete(self, body: Dict):
        self.manager.delete(self._model_arg(body))
        self._send_json({})

    def _api_generate(self, body: Dict):
        model = self._model_arg(body)
        prompt = body.get("prompt", "")
        ka = body.get("keep_alive")
        if not prompt and not body.get("context"):
            if ka is not None and parse_keep_alive(ka) == 0.0:
                # empty prompt + keep_alive 0 = `ollama stop`
                self.manager.stop(model)
                self._send_json({"model": model, "created_at": _now_iso(),
                                 "response": "", "done": True,
                                 "done_reason": "unload"})
                return
            # empty generate is Ollama's "load the model" ping
            self.manager.require_loaded(model, keep_alive=ka)
            self._send_json({"model": model, "created_at": _now_iso(),
                             "response": "", "done": True,
                             "done_reason": "load"})
            return
        lm = self.manager.require_loaded(model, keep_alive=ka)
        raw = bool(body.get("raw", False))
        text = prompt if raw else lm.render_prompt(
            prompt, system=body.get("system"),
            template=body.get("template"), suffix=body.get("suffix"))
        gen = lm.generate_stream(text,
                                 options=self._inject_tenant(
                                     body.get("options")),
                                 context=body.get("context"),
                                 images=body.get("images"),
                                 format=body.get("format"))
        try:
            if body.get("stream", True):
                trace = gen.trace
                gen = self._pull_first(gen)
                self._start_stream()
                co = self._coalescer(
                    b'{"model": ' + json.dumps(model).encode()
                    + b', "created_at": "',
                    b'", "response": ', b', "done": false}\n',
                    body.get("options"), trace=trace)
                for piece, final in gen:
                    if final is None:
                        co.add(piece)
                    else:
                        co.flush()
                        self._stream_json(self._final_frame(model, final,
                                                            body))
                self._end_stream()
            else:
                final = self._drain(gen)
                out = self._final_frame(model, final, body)
                out["response"] = final.text
                self._send_json(out)
        finally:
            # the idle window starts when the generation ends
            self.manager.touch(lm, self.manager.keep_alive_s(ka))

    @staticmethod
    def _drain(gen):
        """The final GenerateResult of a generation stream."""
        final = None
        for _piece, f in gen:
            if f is not None:
                final = f
        return final

    @staticmethod
    def _final_frame(model: str, res, body: Dict) -> Dict:
        out = {
            "model": model, "created_at": _now_iso(), "response": "",
            "done": True, "done_reason": res.done_reason,
            "total_duration": int(res.total_s * 1e9),
            "load_duration": 0,
            "prompt_eval_count": res.prompt_tokens,
            "prompt_eval_duration": int(res.ttft_s * 1e9),
            "eval_count": res.generated_tokens,
            "eval_duration": int(max(res.total_s - res.ttft_s, 0.0) * 1e9),
        }
        if body.get("context") is not None or not body.get("raw"):
            out["context"] = res.context
        if res.timings is not None:
            # options.trace true: the span summary, and the id that
            # fetches the whole timeline from /debug/trace
            out["timings"] = dict(res.timings, request_id=res.request_id)
        return out

    def _api_chat(self, body: Dict):
        model = self._model_arg(body)
        messages = body.get("messages", [])
        ka = body.get("keep_alive")
        if not messages and ka is not None and parse_keep_alive(ka) == 0.0:
            self.manager.stop(model)
            self._send_json({"model": model, "created_at": _now_iso(),
                             "message": {"role": "assistant", "content": ""},
                             "done": True, "done_reason": "unload"})
            return
        lm = self.manager.require_loaded(model, keep_alive=ka)
        try:
            self._chat(lm, model, body, messages)
        finally:
            self.manager.touch(lm, self.manager.keep_alive_s(ka))

    def _chat(self, lm: LoadedModel, model: str, body: Dict, messages):
        stream = body.get("stream", True)
        tools = body.get("tools")
        prompt = lm.render_chat(messages, template=body.get("template"),
                                tools=tools)
        images = []
        for m in messages:
            images.extend(m.get("images") or [])
        gen = lm.generate_stream(prompt,
                                 options=self._inject_tenant(
                                     body.get("options")),
                                 images=images, format=body.get("format"))

        def chat_frame(final) -> Dict:
            out = self._final_frame(model, final, body)
            out.pop("response", None)
            out.pop("context", None)
            out["message"] = {"role": "assistant", "content": ""}
            return out

        if stream and not tools:
            trace = gen.trace
            gen = self._pull_first(gen)
            self._start_stream()
            co = self._coalescer(
                b'{"model": ' + json.dumps(model).encode()
                + b', "created_at": "',
                b'", "message": {"role": "assistant", "content": ',
                b'}, "done": false}\n', body.get("options"), trace=trace)
            for piece, final in gen:
                if final is None:
                    co.add(piece)
                else:
                    co.flush()
                    self._stream_json(chat_frame(final))
            self._end_stream()
            return
        final = self._drain(gen)
        out = chat_frame(final)
        # JSON tool invocations become structured tool_calls (prose around
        # them stays as content)
        msg = {"role": "assistant", "content": final.text}
        if tools:
            calls, prose = split_tool_calls(final.text)
            if calls:
                msg = {"role": "assistant", "content": prose,
                       "tool_calls": calls}
        if stream:
            # a tool answer streams as one message frame and the final
            # frame: the invocation parses only once the output is whole
            self._start_stream()
            self._stream_json({"model": model, "created_at": _now_iso(),
                               "message": msg, "done": False})
            self._stream_json(out)
            self._end_stream()
        else:
            out["message"] = msg
            self._send_json(out)

    # -- OpenAI compatibility ----------------------------------------------
    def _oai_chat(self, body: Dict):
        model = self._model_arg(body)
        lm = self.manager.require_loaded(model)
        try:
            self._oai_chat_on(lm, model, body)
        finally:
            self.manager.touch(lm, self.manager.keep_alive_s())

    def _oai_chat_on(self, lm: LoadedModel, model: str, body: Dict):
        options = {}
        for key in ("temperature", "top_p", "seed", "frequency_penalty",
                    "presence_penalty"):
            if body.get(key) is not None:
                options[key] = body[key]
        if body.get("max_tokens") is not None:
            options["num_predict"] = body["max_tokens"]
        if body.get("stop"):
            options["stop"] = body["stop"]
        tools = body.get("tools")
        prompt = lm.render_chat(body.get("messages", []), tools=tools)
        rid = f"chatcmpl-{int(time.time() * 1000)}"
        created = int(time.time())
        # response_format → grammar-constrained decoding: json_schema
        # carries its schema to the skeleton machine (ops/schema.py),
        # json_object asks for the generic JSON grammar
        rf = body.get("response_format") or {}
        fmt = None
        if isinstance(rf, dict):
            if rf.get("type") == "json_schema":
                js = rf.get("json_schema")
                fmt = (js.get("schema") if isinstance(js, dict)
                       else None) or "json"
            elif rf.get("type") == "json_object":
                fmt = "json"
        gen = lm.generate_stream(prompt, options=self._inject_tenant(options),
                                 format=fmt)

        def chunk(delta, finish) -> bytes:
            return self._sse({
                "id": rid, "object": "chat.completion.chunk",
                "created": created, "model": model,
                "choices": [{"index": 0, "delta": delta,
                             "finish_reason": finish}]})

        def usage(final) -> Dict:
            return {"prompt_tokens": final.prompt_tokens,
                    "completion_tokens": final.generated_tokens,
                    "total_tokens": (final.prompt_tokens
                                     + final.generated_tokens)}

        if not tools and body.get("stream"):
            gen = self._pull_first(gen)
            self._start_stream(ctype="text/event-stream")
            self._chunk(chunk({"role": "assistant", "content": ""}, None))
            co = self._coalescer(
                b'data: {"id": ' + json.dumps(rid).encode()
                + b', "object": "chat.completion.chunk", "created": '
                + str(created).encode() + b', "model": '
                + json.dumps(model).encode()
                + b', "choices": [{"index": 0, "delta": {"content": ',
                None, b'}, "finish_reason": null}]}\n\n', options)
            final = None
            for piece, f in gen:
                if f is None:
                    co.add(piece)
                else:
                    final = f
            co.flush()
            self._chunk(chunk({}, final.done_reason))
            self._chunk(b"data: [DONE]\n\n")
            self._end_stream()
            return
        final = self._drain(gen)
        msg = {"role": "assistant", "content": final.text}
        finish = final.done_reason
        if tools:
            # tool invocations parse from the whole output
            calls, prose = split_tool_calls(final.text)
            if calls:
                msg = {"role": "assistant", "content": prose or None,
                       "tool_calls": [
                           {"id": f"call_{rid}_{i}", "type": "function",
                            "function": {
                                "name": c["function"]["name"],
                                "arguments": json.dumps(
                                    c["function"]["arguments"])}}
                           for i, c in enumerate(calls)]}
                finish = "tool_calls"
            if body.get("stream"):
                # the finished message as one SSE delta, then the finish
                self._start_stream(ctype="text/event-stream")
                delta = dict(msg)
                if delta.get("tool_calls"):
                    # SSE deltas carry an index on each entry
                    delta["tool_calls"] = [dict(tc, index=i) for i, tc in
                                           enumerate(delta["tool_calls"])]
                self._chunk(chunk(delta, None))
                self._chunk(chunk({}, finish))
                self._chunk(b"data: [DONE]\n\n")
                self._end_stream()
                return
        self._send_json({
            "id": rid, "object": "chat.completion", "created": created,
            "model": model,
            "choices": [{"index": 0, "message": msg,
                         "finish_reason": finish}],
            "usage": usage(final)})

    def _oai_completions(self, body: Dict):
        model = self._model_arg(body)
        lm = self.manager.require_loaded(model)
        options = {}
        if body.get("max_tokens") is not None:
            options["num_predict"] = body["max_tokens"]
        if body.get("temperature") is not None:
            options["temperature"] = body["temperature"]
        if body.get("stop"):
            options["stop"] = body["stop"]
        try:
            final = self._drain(lm.generate_stream(
                body.get("prompt", ""),
                options=self._inject_tenant(options)))
        finally:
            self.manager.touch(lm, self.manager.keep_alive_s())
        self._send_json({
            "id": f"cmpl-{int(time.time() * 1000)}",
            "object": "text_completion", "created": int(time.time()),
            "model": model,
            "choices": [{"index": 0, "text": final.text,
                         "finish_reason": final.done_reason}],
            "usage": {"prompt_tokens": final.prompt_tokens,
                      "completion_tokens": final.generated_tokens,
                      "total_tokens": (final.prompt_tokens
                                       + final.generated_tokens)}})


def _register_gauges(manager: ModelManager):
    """The /metrics gauges, read at every scrape over ``manager``'s
    resident models (a weak reference: a stopped manager reads 0)."""
    ref = weakref.ref(manager)

    def over_models(fn, engines=False):
        """Sum ``fn`` over the resident models (with ``engines``, over those
        that have an engine: an embedding model has none)."""
        def total():
            mm = ref()
            return float(sum(fn(lm) for lm in mm.resident()
                             if not engines or hasattr(lm, "engine"))
                         ) if mm else 0.0
        return total

    def util(field):
        return over_models(lambda lm: lm.scheduler.utilization_stats().get(
            field) or 0.0)

    def device_bytes():
        mm = ref()
        dev = mm.device if mm is not None else None
        return float(torch.cuda.memory_allocated(dev)
                     if dev is not None and dev.type == "cuda" else 0)

    for name, fn in (
            ("tpu_model_active_slots",
             over_models(lambda lm: lm.scheduler.n_active)),
            ("tpu_model_queue_depth",
             over_models(lambda lm: lm.scheduler.qsize)),
            ("tpu_model_kv_free_pages",
             over_models(lambda lm: lm.engine.free_pages, engines=True)),
            ("tpu_model_radix_pages",
             over_models(lambda lm: lm.engine.radix_pages, engines=True)),
            ("tpu_model_mfu", util("mfu")),
            ("tpu_model_goodput_tokens_per_second", util("goodput_tok_s")),
            ("tpu_model_hbm_bytes_in_use", device_bytes),
            ("tpu_model_flight_recorder_events", lambda: float(FLIGHT.seq)),
            ("tpu_model_flight_recorder_dumps",
             lambda: float(FLIGHT.dumps))):
        METRICS.gauge_fn(name, fn)


def serve(manager: ModelManager, host: str = "0.0.0.0", port: int = 11434
          ) -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; returns it (its
    ``server_address`` carries the bound port when ``port`` is 0). Stop
    it with ``shutdown()`` and ``server_close()``."""
    _register_gauges(manager)
    handler = type("BoundHandler", (Handler,), {"manager": manager})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="http-server").start()
    return httpd
