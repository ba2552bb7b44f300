"""Model manager + Ollama-compatible HTTP server (stdlib, threaded).

Counterpart of ``ollama_operator_tpu/server/app.py`` for the routes this
slice serves:

  GET  /                  liveness banner
  GET  /api/version
  GET  /api/tags          the resident models
  POST /api/generate      generation, streamed (NDJSON) or not; ``suffix``
                          (fill-in-middle) as the reference renders it,
                          ``images`` and ``format`` refused with 400 until
                          vision and grammars are ported, ``keep_alive``
                          parsed as the reference does (an empty prompt
                          with 0 unloads the model; no idle timer yet)

The manager holds models built in-process (``ModelManager.preload`` from
dense params, with the weight dtype resolved per model as the JAX loader
does, or ``ModelManager.add``); loading from GGUF files and the registry
waits for a later slice.
"""

from __future__ import annotations

import json
import math
import re
import threading
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import torch

from .. import __version__
from ..device import resolve_device
from ..ops import quant as Q
from ..runtime.engine import resolve_engine_dtype
from ..runtime.scheduler import SchedulerBroken, SchedulerBusy
from ..runtime.service import BadRequest, LoadedModel

ENGINE_DTYPES = ("bfloat16", "float32", "int8", "int4")


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")


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


class ModelManager:
    """The resident models, by name, all on one device (the card unless
    the caller asks for the CPU). Every model is loaded up front; a
    request for any other name is a 404."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._models: Dict[str, LoadedModel] = {}
        self._lock = threading.Lock()

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
        engine_dtype = dtype or resolve_engine_dtype(cfg, self.device)
        lm = LoadedModel(name, cfg,
                         apply_engine_dtype(params, engine_dtype,
                                            self.device),
                         tokenizer, device=self.device, **kw)
        lm.serving_dtype = engine_dtype
        return self.add(lm)

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
            return self._models.get(name) or self._models.get(
                name.split(":")[0])

    def require_loaded(self, name: str, keep_alive=None) -> LoadedModel:
        """The resident model ``name`` (404 if none). A ``keep_alive``
        that :func:`parse_keep_alive` refuses is a 400; a valid one is
        accepted and changes nothing (the manager has no idle timer)."""
        if keep_alive is not None:
            try:
                parse_keep_alive(keep_alive)
            except ValueError:
                raise ApiError(400, f"invalid keep_alive "
                                    f"{keep_alive!r}") from None
        lm = self._find(name)
        if lm is None:
            raise ApiError(404, f"model {name!r} not found")
        return lm

    def stop(self, name: str) -> None:
        """keep_alive 0 with an empty prompt (``ollama stop``): take the
        model out of the manager, so that later requests for it are 404s,
        and unload it once the requests it is serving have finished (a
        name that is not resident is left as it is)."""
        lm = self._find(name)
        if lm is None:
            return
        with self._lock:
            if self._models.get(lm.name) is lm:
                del self._models[lm.name]
        if lm.scheduler.has_pending:
            threading.Thread(target=lm.unload_when_idle, daemon=True,
                             name=f"unload-{lm.name}").start()
        else:
            lm.unload()

    def list_models(self) -> List[Dict]:
        with self._lock:
            models = list(self._models.values())
        return [{"name": lm.name, "model": lm.name,
                 "modified_at": datetime.fromtimestamp(
                     lm.loaded_at, timezone.utc).isoformat(),
                 "size": 0, "digest": "",
                 "details": {"family": lm.cfg.arch, "format": "torch",
                             "parameter_size": f"{lm.cfg.n_params / 1e9:.1f}B",
                             "quantization_level": lm.serving_dtype or ""}}
                for lm in models]

    def shutdown(self):
        with self._lock:
            models = list(self._models.values())
            self._models.clear()
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
        else:
            self._send_json({"error": "not found"}, 404)

    def do_POST(self):
        try:
            body = self._json_body()
            if self.path.split("?")[0] != "/api/generate":
                raise ApiError(404, "not found")
            self._api_generate(body)
        except ApiError as e:
            self._send_error(str(e), e.status)
        except BadRequest as e:
            self._send_error(str(e), 400)
        except SchedulerBusy as e:
            self._send_error(str(e), 503)
        except SchedulerBroken as e:
            self._send_error(str(e), 500)
        except (BrokenPipeError, ConnectionResetError):
            pass
        except Exception as e:  # noqa: BLE001 — the request boundary
            self._send_error(f"internal: {e}", 500)

    def _api_generate(self, body: Dict):
        model = body.get("model") or body.get("name")
        if not model:
            raise ApiError(400, "missing 'model'")
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
