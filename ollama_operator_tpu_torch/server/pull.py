"""`python -m ollama_operator_tpu_torch.server.pull <model>` — init-container pull.

A copy of ``ollama_operator_tpu/server/pull.py``. A model pod's puller init
container runs `ollama pull <image>` with OLLAMA_HOST pointed at the shared
store Service, so the *store* server (``python -m
ollama_operator_tpu_torch.server --store-only``) downloads into the shared
volume and the model pod starts only once the blobs exist. This is the same
client: POST /api/pull to $OLLAMA_HOST, stream NDJSON progress to stdout,
exit non-zero on error so the init container restarts.
"""

from __future__ import annotations

import json
import os
import sys
import time
import urllib.error
import urllib.request


def resolve_host(raw: str) -> str:
    raw = raw or "127.0.0.1:11434"
    if "://" not in raw:
        raw = "http://" + raw
    if raw.count(":") < 2:  # no explicit port after scheme
        raw = raw + ":11434"
    return raw.rstrip("/")


def pull(model: str, host: str, retries: int = 1080,
         retry_delay: float = 5.0) -> int:
    """Pull with retry-until-store-up: the init container may start before
    the store StatefulSet is Ready (`ollama pull` would fail and the init
    container restart; this retries in-process to keep restart counts
    clean)."""
    url = f"{resolve_host(host)}/api/pull"
    body = json.dumps({"model": model, "stream": True}).encode()
    attempt = 0
    while True:
        attempt += 1
        try:
            req = urllib.request.Request(
                url, data=body, headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=24 * 3600) as resp:
                ok = False
                for line in resp:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        evt = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    print(json.dumps(evt), flush=True)
                    if evt.get("error"):
                        print(f"pull failed: {evt['error']}", file=sys.stderr)
                        return 1
                    if evt.get("status") == "success":
                        ok = True
                return 0 if ok else 1
        except urllib.error.HTTPError as e:
            # a definitive HTTP response is not "store unreachable": 4xx is
            # a permanent error (bad model ref) — exit so the failure shows
            # up in pod status; 5xx may be store startup/backpressure
            if e.code < 500:
                print(f"pull failed: HTTP {e.code}: "
                      f"{e.read().decode(errors='replace')[:500]}",
                      file=sys.stderr)
                return 1
            if attempt >= retries:
                print(f"pull: giving up after {attempt} attempts: {e}",
                      file=sys.stderr)
                return 1
            print(f"pull: store returned {e.code}; retry {attempt} in "
                  f"{retry_delay:.0f}s", file=sys.stderr)
            time.sleep(retry_delay)
        except (urllib.error.URLError, ConnectionError, TimeoutError, OSError) as e:
            if attempt >= retries:
                print(f"pull: giving up after {attempt} attempts: {e}",
                      file=sys.stderr)
                return 1
            print(f"pull: store not reachable ({e}); retry {attempt} in "
                  f"{retry_delay:.0f}s", file=sys.stderr)
            time.sleep(retry_delay)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("usage: python -m ollama_operator_tpu_torch.server.pull <model>",
              file=sys.stderr)
        return 2
    return pull(argv[0], os.environ.get("OLLAMA_HOST", ""))


if __name__ == "__main__":
    sys.exit(main())
