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
  POST /api/show          modelfile, template, parameters, details
  DELETE /api/delete      remove a model from the store (POST too)
  POST /api/generate      generation, streamed (NDJSON) or not; ``suffix``
                          (fill-in-middle) as the reference renders it,
                          ``images`` and ``format`` refused with 400 until
                          vision and grammars are ported, ``keep_alive``
                          parsed as the reference does

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

import json
import math
import os
import re
import sys
import threading
import time
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

from .. import __version__
from ..convert import params_from_numpy
from ..device import resolve_device
from ..gguf.reader import GGUFFile
from ..gguf.transcode import (config_from_gguf, is_encoder_arch,
                              load_model as transcode_load)
from ..models.decoder import check_supported
from ..ops import cuda_build
from ..ops import quant as Q
from ..runtime.engine import (EngineConfig, resolve_engine_dtype,
                              resolve_serving_defaults)
from ..runtime.scheduler import SchedulerBroken, SchedulerBusy
from ..runtime.service import BadRequest, LoadedModel
from ..tokenizer import Tokenizer
from .modelfile import Modelfile
from .names import ModelName
from .registry import (MT_ADAPTER, MT_LICENSE, MT_MODEL, MT_PARAMS,
                       MT_PROJECTOR, MT_SYSTEM, MT_TEMPLATE, ModelStore,
                       RegistryClient, RegistryError)

ENGINE_DTYPES = ("bfloat16", "float32", "int8", "int4")


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")


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


# the model-layer media types the port cannot serve yet: an adapter would
# be merged into the weights, a projector is a vision tower (ROADMAP
# Queue 1 item 8); serving the model without them would be wrong
_UNPORTED_LAYERS = {MT_ADAPTER: "a LoRA adapter (ADAPTER) layer",
                    MT_PROJECTOR: "a vision projector (PROJECTOR) layer"}

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
    ``clock`` is the reaper's clock and ``reap_every_s`` its period."""

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
        :class:`LoadedModel` (``kv_dtype``, ``paged``, ``ecfg``, ...)."""
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
        if old is not None and old is not lm:
            old.unload()
        return lm

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
        cache) before tearing the old model down, apply the template,
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
            for mt, what in _UNPORTED_LAYERS.items():
                if mt in layers:
                    raise ApiError(501, f"model {name.short} has {what}, "
                                        f"which the torch port does not "
                                        f"serve yet")
            digest = store.model_digest(name) or ""
            with GGUFFile(gguf_path) as hdr:
                if is_encoder_arch(hdr.arch):
                    raise ApiError(501, f"model {name.short} is an "
                                        f"embedding model ({hdr.arch}), "
                                        f"which the torch port does not "
                                        f"serve yet")
                try:
                    hcfg = check_supported(config_from_gguf(hdr))
                except NotImplementedError as e:
                    raise ApiError(501, f"model {name.short}: {e}") from e
            engine_dtype = self.engine_dtype
            if engine_dtype is None:
                engine_dtype = resolve_engine_dtype(hcfg, self.device)
                print(f"serving dtype for {name.short}: {engine_dtype} "
                      f"({hcfg.n_params / 1e9:.2f}B params, auto)",
                      file=sys.stderr)
            cfg, params, tok_md = transcode_load(
                gguf_path, cache_dir=self.cache_dir,
                dtype=transcode_dtype(engine_dtype, self.device),
                digest=digest.replace("sha256:", "")[:24] or None)
            tokenizer = Tokenizer.from_gguf_metadata(tok_md)
            template = self._read_layer_text(layers, MT_TEMPLATE)
            system = self._read_layer_text(layers, MT_SYSTEM)
            params_raw = self._read_layer_text(layers, MT_PARAMS)
            default_params = json.loads(params_raw) if params_raw else {}
            with self._lock:
                old = [m for m in self._models.values()
                       if m.digest is not None]
                for m in old:
                    del self._models[m.name]
                    self._expires.pop(m.name, None)
            for m in old:
                m.unload()
            ecfg = self.ecfg or EngineConfig(max_seq_len=min(
                cfg.max_seq_len, int(default_params.get("num_ctx", 4096))))
            lm = self._build(
                name.short, cfg, params_from_numpy(params, self.device),
                tokenizer, engine_dtype, template=template, system=system,
                default_params=default_params,
                ecfg=resolve_serving_defaults(ecfg, cfg, self.device))
            del params
            lm.digest = digest
            with self._lock:
                self._models[lm.name] = lm
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
        keep-alive deadline, and the bytes the process holds on the card
        (``size_vram``). ``kernel_launches`` counts every kernel launch of
        this process so far (``ops/cuda_build.launches``)."""
        with self._lock:
            models = [(lm, self._expires.get(lm.name))
                      for lm in self._models.values()]
        vram = (torch.cuda.memory_allocated(self.device)
                if self.device is not None and self.device.type == "cuda"
                else 0)
        out = []
        for lm, exp in models:
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
                            "decode_chunk": lm.engine.ecfg.decode_chunk,
                            "paged": bool(lm.engine.paged)},
                "expires_at": expires,
                "size_vram": vram,
                "kernel_launches": dict(cuda_build.launches),
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

    def shutdown(self):
        self._reaper_stop.set()
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

    def _send_json(self, obj, status=200):
        body = json.dumps(obj).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _chunk(self, data: bytes):
        self.wfile.write(f"{len(data):x}\r\n".encode() + data + b"\r\n")
        self.wfile.flush()

    def _send_error(self, message: str, status: int):
        if getattr(self, "_streaming", False):
            # headers are out: the error becomes the stream's last frame
            self._chunk(json.dumps({"error": message}).encode() + b"\n")
            self._chunk(b"")
            self._streaming = False
        else:
            self._send_json({"error": message}, status)

    def do_GET(self):
        try:
            path = self.path.split("?")[0]
            if path == "/":
                body = b"Ollama is running"
                self.send_response(200)
                self.send_header("Content-Type", "text/plain; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            elif path == "/api/version":
                self._send_json({"version": __version__})
            elif path == "/api/tags":
                self._send_json({"models": self.manager.list_models()})
            elif path == "/api/ps":
                self._send_json({"models": self.manager.ps()})
            else:
                self._send_json({"error": "not found"}, 404)
        except ApiError as e:
            self._send_json({"error": str(e)}, e.status)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — the request boundary
            self._send_json({"error": f"internal: {e}"}, 500)

    def do_HEAD(self):
        ok = self.path.split("?")[0] == "/"
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

    def do_POST(self):
        try:
            body = self._json_body()
            route = {"/api/generate": self._api_generate,
                     "/api/pull": self._api_pull,
                     "/api/show": self._api_show,
                     "/api/delete": self._api_delete,
                     }.get(self.path.split("?")[0])
            if route is None:
                raise ApiError(404, "not found")
            route(body)
        except ApiError as e:
            self._send_error(str(e), e.status)
        except BadRequest as e:
            self._send_error(str(e), 400)
        except SchedulerBusy as e:
            self._send_error(str(e), 503)
        except (SchedulerBroken, RegistryError) as e:
            self._send_error(str(e), 500)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — the request boundary
            self._send_error(f"internal: {e}", 500)

    @staticmethod
    def _model_arg(body: Dict) -> str:
        model = body.get("model") or body.get("name")
        if not model:
            raise ApiError(400, "missing 'model'")
        return model

    def _api_pull(self, body: Dict):
        model = self._model_arg(body)
        self.manager.require_store()
        if not body.get("stream", True):
            self.manager.pull(model)
            self._send_json({"status": "success"})
            return
        self.send_response(200)
        self.send_header("Content-Type", "application/x-ndjson")
        self.send_header("Transfer-Encoding", "chunked")
        self.end_headers()
        self._streaming = True

        def progress(status, completed, total, digest=None):
            msg = {"status": status}
            if total:
                msg["total"] = total
                msg["completed"] = completed
            if digest:
                msg["digest"] = digest
            self._chunk(json.dumps(msg).encode() + b"\n")

        try:
            self.manager.pull(model, progress)
        except RegistryError as e:
            self._chunk(json.dumps({"error": str(e)}).encode() + b"\n")
        self._chunk(b"")
        self._streaming = False

    def _api_show(self, body: Dict):
        self._send_json(self.manager.show(self._model_arg(body)))

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
        gen = lm.generate_stream(text, options=body.get("options"),
                                 context=body.get("context"),
                                 images=body.get("images"),
                                 format=body.get("format"))
        try:
            self._respond(model, gen, body)
        finally:
            # the idle window starts when the generation ends
            self.manager.touch(lm, self.manager.keep_alive_s(ka))

    def _respond(self, model: str, gen, body: Dict):
        if body.get("stream", True):
            self.send_response(200)
            self.send_header("Content-Type", "application/x-ndjson")
            self.send_header("Transfer-Encoding", "chunked")
            self.end_headers()
            self._streaming = True
            for piece, final in gen:
                if final is None:
                    frame = {"model": model, "created_at": _now_iso(),
                             "response": piece, "done": False}
                else:
                    frame = self._final_frame(model, final, body)
                self._chunk(json.dumps(frame).encode() + b"\n")
            self._chunk(b"")
            self._streaming = False
        else:
            final = None
            for _piece, f in gen:
                if f is not None:
                    final = f
            out = self._final_frame(model, final, body)
            out["response"] = final.text
            self._send_json(out)

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
        return out


def serve(manager: ModelManager, host: str = "0.0.0.0", port: int = 11434
          ) -> ThreadingHTTPServer:
    """Start the HTTP server on a daemon thread; returns it (its
    ``server_address`` carries the bound port when ``port`` is 0). Stop
    it with ``shutdown()`` and ``server_close()``."""
    handler = type("BoundHandler", (Handler,), {"manager": manager})
    httpd = ThreadingHTTPServer((host, port), handler)
    httpd.daemon_threads = True
    threading.Thread(target=httpd.serve_forever, daemon=True,
                     name="http-server").start()
    return httpd
