"""Model manager + Ollama-compatible HTTP server (stdlib, threaded).

Counterpart of ``ollama_operator_tpu/server/app.py`` for the routes this
slice serves:

  GET  /                  liveness banner
  GET  /api/version
  GET  /api/tags          the resident models
  POST /api/generate      generation, streamed (NDJSON) or not

The manager holds models built in-process (``ModelManager.add``);
loading from GGUF files and the registry waits for a later slice.
"""

from __future__ import annotations

import json
import threading
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List

from .. import __version__
from ..device import resolve_device
from ..runtime.scheduler import SchedulerBroken, SchedulerBusy
from ..runtime.service import BadRequest, LoadedModel


def _now_iso() -> str:
    return datetime.now(timezone.utc).isoformat().replace("+00:00", "Z")


class ApiError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status


class ModelManager:
    """The resident models, by name, all on one device (the card unless
    the caller asks for the CPU). Every model is loaded up front; a
    request for any other name is a 404."""

    def __init__(self, device="cuda"):
        self.device = resolve_device(device)
        self._models: Dict[str, LoadedModel] = {}
        self._lock = threading.Lock()

    def preload(self, name: str, cfg, params, tokenizer,
                **kw) -> LoadedModel:
        """Build a LoadedModel on the manager's device and add it."""
        return self.add(LoadedModel(name, cfg, params, tokenizer,
                                    device=self.device, **kw))

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

    def require_loaded(self, name: str) -> LoadedModel:
        with self._lock:
            lm = self._models.get(name) or self._models.get(
                name.split(":")[0])
        if lm is None:
            raise ApiError(404, f"model {name!r} not found")
        return lm

    def list_models(self) -> List[Dict]:
        with self._lock:
            models = list(self._models.values())
        return [{"name": lm.name, "model": lm.name,
                 "modified_at": datetime.fromtimestamp(
                     lm.loaded_at, timezone.utc).isoformat(),
                 "size": 0, "digest": "",
                 "details": {"family": lm.cfg.arch, "format": "torch",
                             "parameter_size": f"{lm.cfg.n_params / 1e9:.1f}B",
                             "quantization_level": ""}}
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
        lm = self.manager.require_loaded(model)
        prompt = body.get("prompt", "")
        if not prompt and not body.get("context"):
            self._send_json({"model": model, "created_at": _now_iso(),
                             "response": "", "done": True,
                             "done_reason": "load"})
            return
        raw = bool(body.get("raw", False))
        text = prompt if raw else lm.render_prompt(
            prompt, system=body.get("system"),
            template=body.get("template"))
        gen = lm.generate_stream(text, options=body.get("options"),
                                 context=body.get("context"))
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
