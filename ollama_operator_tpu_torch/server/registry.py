"""Ollama registry client + local model store.

Counterpart of ``ollama_operator_tpu/server/registry.py``: the media-type
constants, ``ModelStore`` (with its write side: blobs added from bytes,
from a client's upload stream and from a server-side file) and
``RegistryClient``'s ``pull`` and ``push``. The client speaks the registry
protocol that `ollama pull` and `ollama push` speak:

  GET  /v2/<ns>/<name>/manifests/<tag>   (docker manifest v2 JSON)
  GET  /v2/<ns>/<name>/blobs/<digest>    (content-addressed layers)
  HEAD /v2/<ns>/<name>/blobs/<digest>    (does the registry hold it?)
  POST /v2/<ns>/<name>/blobs/uploads/    (an upload session), then
  PUT  <Location>?digest=<digest>        (the blob's bytes)
  PUT  /v2/<ns>/<name>/manifests/<tag>   (the manifest, last)

Layer mediaTypes: application/vnd.ollama.image.{model,template,system,
params,license,adapter,projector} — the model layer is the GGUF file.

The on-disk layout is ollama's, byte for byte the JAX package's, so one
shared volume serves both packages (pull once, every replica mmap-shares):

  <root>/blobs/sha256-<hex>
  <root>/manifests/<registry>/<ns>/<name>/<tag>

Downloads stream to a unique .partial file and are verified against the
digest before being atomically published; interrupted pulls resume via HTTP
Range. Uploads (``put_blob_stream``) verify the declared digest on the way
and leave no partial blob behind on a mismatch or a short body.
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import threading
import time
import urllib.error
import urllib.request
from typing import Callable, Dict, List, Optional

from .names import ModelName

MT_MODEL = "application/vnd.ollama.image.model"
MT_TEMPLATE = "application/vnd.ollama.image.template"
MT_SYSTEM = "application/vnd.ollama.image.system"
MT_PARAMS = "application/vnd.ollama.image.params"
MT_LICENSE = "application/vnd.ollama.image.license"
MT_ADAPTER = "application/vnd.ollama.image.adapter"
MT_PROJECTOR = "application/vnd.ollama.image.projector"
MANIFEST_MT = "application/vnd.docker.distribution.manifest.v2+json"
MANIFEST_ACCEPT = ("application/vnd.docker.distribution.manifest.v2+json, "
                   "application/vnd.oci.image.manifest.v1+json")

# (status, completed, total, digest=None) — digest set on blob progress so
# clients (the ollama CLI keys per-layer progress bars on it) can track layers
ProgressCb = Callable[..., None]


class RegistryError(RuntimeError):
    pass


_HEX64 = re.compile(r"[0-9a-f]{64}\Z")


def valid_blob_digest(digest: str) -> bool:
    """True iff ``digest`` is ``sha256:`` + 64 lowercase hex chars.

    Checked before any filesystem access derived from a client-supplied
    digest: ``blob_path`` joins the digest into a path, so a digest
    holding ``/../`` would otherwise reach outside the blobs directory."""
    algo, _, hexd = digest.partition(":")
    return algo == "sha256" and _HEX64.match(hexd) is not None


class ModelStore:
    """Local content-addressed store of model blobs + manifests."""

    def __init__(self, root: str):
        self.root = root
        os.makedirs(os.path.join(root, "blobs"), exist_ok=True)
        os.makedirs(os.path.join(root, "manifests"), exist_ok=True)

    # -- paths ------------------------------------------------------------
    def blob_path(self, digest: str) -> str:
        return os.path.join(self.root, "blobs", digest.replace(":", "-"))

    def manifest_path(self, name: ModelName) -> str:
        return os.path.join(self.root, "manifests", name.registry_host,
                            name.namespace, name.name, name.tag)

    def has_blob(self, digest: str) -> bool:
        return os.path.exists(self.blob_path(digest))

    # -- manifests --------------------------------------------------------
    def write_manifest(self, name: ModelName, manifest: dict):
        path = self.manifest_path(name)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + f".tmp.{os.getpid()}"
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, path)

    def read_manifest(self, name: ModelName) -> Optional[dict]:
        try:
            with open(self.manifest_path(name)) as f:
                return json.load(f)
        except FileNotFoundError:
            return None

    def delete_model(self, name: ModelName) -> bool:
        path = self.manifest_path(name)
        if not os.path.exists(path):
            return False
        os.remove(path)
        self.gc()
        return True

    def list_models(self) -> List[dict]:
        out = []
        mroot = os.path.join(self.root, "manifests")
        for dirpath, _dirs, files in os.walk(mroot):
            for tag in files:
                if tag.startswith("."):
                    continue
                rel = os.path.relpath(os.path.join(dirpath, tag), mroot)
                parts = rel.split(os.sep)
                if len(parts) < 4:
                    continue
                # registry / <namespace…> / name / tag — the namespace may
                # span several path segments
                reg, ns, nm, tg = (parts[0], "/".join(parts[1:-2]),
                                   parts[-2], parts[-1])
                name = ModelName(reg, ns, nm, tg)
                try:
                    with open(os.path.join(dirpath, tag)) as f:
                        manifest = json.load(f)
                except (OSError, json.JSONDecodeError):
                    continue
                size = sum(l.get("size", 0)
                           for l in manifest.get("layers", []))
                out.append({"name": name, "manifest": manifest,
                            "size": size,
                            "modified_at": os.path.getmtime(
                                os.path.join(dirpath, tag))})
        return out

    def gc(self):
        """Delete blobs referenced by no manifest (ollama's prune)."""
        referenced = set()
        for m in self.list_models():
            cfg = m["manifest"].get("config", {})
            if cfg.get("digest"):
                referenced.add(cfg["digest"].replace(":", "-"))
            for layer in m["manifest"].get("layers", []):
                referenced.add(layer["digest"].replace(":", "-"))
        bdir = os.path.join(self.root, "blobs")
        now = time.time()
        for b in os.listdir(bdir):
            p = os.path.join(bdir, b)
            if ".partial" in b:
                # abandoned downloads (live writers keep mtime fresh)
                try:
                    if now - os.path.getmtime(p) >= 3600:
                        os.remove(p)
                except OSError:
                    pass
            elif b not in referenced:
                os.remove(p)

    # -- model assembly ---------------------------------------------------
    def model_layers(self, name: ModelName) -> Dict[str, str]:
        """mediaType → blob path for a pulled model."""
        manifest = self.read_manifest(name)
        if manifest is None:
            raise RegistryError(f"model {name.short} not found locally")
        out = {}
        for layer in manifest.get("layers", []):
            out[layer["mediaType"]] = self.blob_path(layer["digest"])
        return out

    def model_digest(self, name: ModelName, media_type: str = MT_MODEL
                     ) -> Optional[str]:
        manifest = self.read_manifest(name)
        if manifest is None:
            return None
        for layer in manifest.get("layers", []):
            if layer["mediaType"] == media_type:
                return layer["digest"]
        return None

    # -- local create (/api/create, /api/blobs) ---------------------------
    def _tmp(self, path: str) -> str:
        # unique per writer: the server is threaded, and two uploads of one
        # digest must not share a temporary inode
        return path + f".partial.{os.getpid()}.{threading.get_ident()}"

    def add_blob(self, data: bytes) -> dict:
        digest = "sha256:" + hashlib.sha256(data).hexdigest()
        path = self.blob_path(digest)
        if not os.path.exists(path):
            tmp = self._tmp(path)
            with open(tmp, "wb") as f:
                f.write(data)
            os.replace(tmp, path)
        return {"digest": digest, "size": len(data)}

    def put_blob_stream(self, digest: str, fileobj, length: int) -> dict:
        """A client's blob upload (POST /api/blobs/<digest>): stream
        ``length`` bytes to the content-addressed path, checking the
        declared sha256 on the way. A mismatch or a short body raises and
        leaves no partial file behind; a blob already present has its body
        read and dropped, so the connection stays usable."""
        if not valid_blob_digest(digest):
            raise RegistryError(f"unsupported digest {digest!r}")
        path = self.blob_path(digest)
        if os.path.exists(path):
            remaining = length
            while remaining > 0:
                chunk = fileobj.read(min(1 << 20, remaining))
                if not chunk:
                    raise RegistryError("short blob body")
                remaining -= len(chunk)
            return {"digest": digest, "size": length}
        h = hashlib.sha256()
        size = 0
        tmp = self._tmp(path)
        try:
            with open(tmp, "wb") as f:
                remaining = length
                while remaining > 0:
                    chunk = fileobj.read(min(1 << 20, remaining))
                    if not chunk:
                        raise RegistryError("short blob body")
                    h.update(chunk)
                    f.write(chunk)
                    size += len(chunk)
                    remaining -= len(chunk)
            got = h.hexdigest()
            if got != digest.partition(":")[2]:
                raise RegistryError(
                    f"digest mismatch: body is sha256:{got}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        return {"digest": digest, "size": size}

    def add_blob_file(self, src: str) -> dict:
        """Copy a server-side file into the store (a Modelfile's FROM or
        ADAPTER path)."""
        h = hashlib.sha256()
        size = 0
        with open(src, "rb") as f:
            while chunk := f.read(1 << 20):
                h.update(chunk)
                size += len(chunk)
        digest = "sha256:" + h.hexdigest()
        path = self.blob_path(digest)
        if not os.path.exists(path):
            tmp = self._tmp(path)
            shutil.copyfile(src, tmp)
            os.replace(tmp, path)
        return {"digest": digest, "size": size}


# An in-flight writer may legitimately go quiet for a full network read
# timeout (RegistryClient timeout=60s) without touching its .partial, so the
# abandoned-partial threshold must exceed that with wide margin — claiming or
# deleting a LIVE partial splits one inode between two writers and corrupts
# the blob.
PARTIAL_STALE_S = 600.0


class RegistryClient:
    def __init__(self, store: ModelStore, timeout: float = 60.0):
        self.store = store
        self.timeout = timeout
        # serialise same-digest downloads within this process; the .partial
        # claim-by-rename below only guards against *other* processes
        self._blob_locks: Dict[str, threading.Lock] = {}
        self._blob_locks_guard = threading.Lock()

    def _blob_lock(self, digest: str) -> threading.Lock:
        with self._blob_locks_guard:
            return self._blob_locks.setdefault(digest, threading.Lock())

    def _open(self, url: str, headers: Dict[str, str]):
        req = urllib.request.Request(url, headers=headers)
        return urllib.request.urlopen(req, timeout=self.timeout)

    def fetch_manifest(self, name: ModelName) -> dict:
        try:
            with self._open(name.manifest_url(),
                            {"Accept": MANIFEST_ACCEPT}) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            if e.code == 404:
                raise RegistryError(
                    f"model {name.short!r} not found in registry") from e
            raise RegistryError(f"manifest fetch failed: {e}") from e
        except urllib.error.URLError as e:
            raise RegistryError(f"registry unreachable: {e}") from e

    def _pull_blob(self, name: ModelName, digest: str, size: int,
                   progress: Optional[ProgressCb], status: str):
        with self._blob_lock(digest):
            self._pull_blob_locked(name, digest, size, progress, status)

    @staticmethod
    def _cleanup_stale_partials(path: str):
        """Remove abandoned .partial files once the blob is installed.

        Only stale ones (mtime older than PARTIAL_STALE_S): a fresh partial
        may belong to a live writer in another process, whose in-flight fd
        must not be yanked."""
        import glob as _glob
        now = time.time()
        for cand in _glob.glob(path + ".partial*"):
            try:
                if now - os.path.getmtime(cand) >= PARTIAL_STALE_S:
                    os.remove(cand)
            except OSError:
                continue

    def _pull_blob_locked(self, name: ModelName, digest: str, size: int,
                          progress: Optional[ProgressCb], status: str):
        path = self.store.blob_path(digest)
        if os.path.exists(path):
            self._cleanup_stale_partials(path)
            if progress:
                progress(status, size, size, digest=digest)
            return
        # each attempt writes its own .partial.<suffix>; to resume, claim an
        # abandoned partial by atomic rename. Only partials whose mtime is
        # stale are claimed: an active writer (another process; same-process
        # writers are excluded by _blob_lock) touches its file continuously,
        # and renaming a live partial would not stop the writer's open fd —
        # both would append to one inode and corrupt the blob.
        partial = path + f".partial.{os.getpid()}.{os.urandom(3).hex()}"
        have = 0
        import glob as _glob
        now = time.time()
        for cand in _glob.glob(path + ".partial*"):
            try:
                if now - os.path.getmtime(cand) < PARTIAL_STALE_S:
                    continue
                os.replace(cand, partial)
                have = os.path.getsize(partial)
                break
            except OSError:
                continue
        headers: Dict[str, str] = {}
        mode = "wb"
        if 0 < have < size:
            headers["Range"] = f"bytes={have}-"
            mode = "ab"
        h = hashlib.sha256()
        try:
            with self._open(name.blob_url(digest), headers) as r:
                if mode == "ab" and r.status != 206:
                    mode, have = "wb", 0  # server ignored Range
                with open(partial, mode) as f:
                    done = have
                    while chunk := r.read(1 << 20):
                        f.write(chunk)
                        done += len(chunk)
                        if progress:
                            progress(status, done, size, digest=digest)
        except urllib.error.URLError as e:
            raise RegistryError(f"blob pull failed: {e}") from e
        # verify the whole file (including any resumed prefix)
        with open(partial, "rb") as f:
            while chunk := f.read(1 << 20):
                h.update(chunk)
        actual = "sha256:" + h.hexdigest()
        if actual != digest:
            os.remove(partial)
            raise RegistryError(
                f"digest mismatch for {digest}: got {actual}")
        os.replace(partial, path)
        self._cleanup_stale_partials(path)

    def pull(self, ref: str, progress: Optional[ProgressCb] = None) -> ModelName:
        """Pull a model by name into the store. Idempotent; resumes."""
        name = ModelName.parse(ref)
        if progress:
            progress("pulling manifest", 0, 0)
        manifest = self.fetch_manifest(name)
        layers = list(manifest.get("layers", []))
        cfg = manifest.get("config")
        if cfg:
            layers.append(cfg)
        for layer in layers:
            self._pull_blob(name, layer["digest"], layer.get("size", 0),
                            progress, f"pulling {layer['digest'][7:19]}")
        if progress:
            progress("writing manifest", 0, 0)
        self.store.write_manifest(name, manifest)
        if progress:
            progress("success", 0, 0)
        return name

    def _request(self, method: str, url: str, data=None,
                 headers: Optional[Dict[str, str]] = None):
        req = urllib.request.Request(url, data=data, method=method,
                                     headers=headers or {})
        return urllib.request.urlopen(req, timeout=self.timeout)

    def _blob_exists(self, name: ModelName, digest: str) -> bool:
        try:
            with self._request("HEAD", name.blob_url(digest)):
                return True
        except urllib.error.HTTPError as e:
            if e.code in (404, 405):
                return False
            raise RegistryError(f"blob HEAD failed: {e}") from e
        except urllib.error.URLError as e:
            raise RegistryError(f"registry unreachable: {e}") from e

    def _push_blob(self, name: ModelName, digest: str, path: str,
                   size: int, progress, label: str):
        """The docker registry v2 two-step upload: POST an upload session,
        then PUT the bytes at its Location with ?digest=. The blob streams
        from disk (model layers are GBs) with progress a chunk."""
        start_url = (f"{name.base_url}/v2/{name.namespace}/{name.name}"
                     f"/blobs/uploads/")
        try:
            with self._request("POST", start_url, data=b"") as r:
                loc = r.headers.get("Location", "")
        except urllib.error.HTTPError as e:
            raise RegistryError(f"upload start failed: {e}") from e
        except urllib.error.URLError as e:
            raise RegistryError(f"registry unreachable: {e}") from e
        if loc.startswith("/"):
            loc = name.base_url + loc
        sep = "&" if "?" in loc else "?"
        put_url = f"{loc}{sep}digest={digest}"

        class _Reader:
            """A file-like body: urllib streams it, read() reports."""

            def __init__(self, f):
                self.f = f
                self.sent = 0

            def read(self, n=-1):
                chunk = self.f.read(n if n and n > 0 else 1 << 20)
                self.sent += len(chunk)
                if progress and chunk:
                    progress(label, min(self.sent, size), size, digest)
                return chunk

            def __len__(self):  # Content-Length for urllib
                return size

        try:
            with open(path, "rb") as f:
                with self._request("PUT", put_url, data=_Reader(f), headers={
                        "Content-Type": "application/octet-stream",
                        "Content-Length": str(size)}):
                    pass
        except urllib.error.HTTPError as e:
            raise RegistryError(f"blob upload failed: {e}") from e
        except urllib.error.URLError as e:
            raise RegistryError(f"registry unreachable: {e}") from e
        except OSError as e:
            raise RegistryError(f"local blob {digest} missing: {e}") from e

    def push(self, ref: str, progress: Optional[ProgressCb] = None
             ) -> ModelName:
        """Push a local model to its registry: a HEAD a blob, an upload of
        each one the registry lacks, then the manifest (the inverse of
        ``pull``, the protocol `ollama push` speaks)."""
        name = ModelName.parse(ref)
        manifest = self.store.read_manifest(name)
        if manifest is None:
            raise RegistryError(f"model {name.short!r} not found locally")
        blobs = list(manifest.get("layers", []))
        if manifest.get("config"):
            blobs.append(manifest["config"])
        for layer in blobs:
            digest = layer["digest"]
            size = layer.get("size", 0)
            label = f"pushing {digest[7:19]}"
            if progress:
                progress(label, 0, size, digest)
            if not self._blob_exists(name, digest):
                self._push_blob(name, digest, self.store.blob_path(digest),
                                size, progress, label)
            if progress:
                progress(label, size, size, digest)
        if progress:
            progress("pushing manifest", 0, 0)
        try:
            with self._request("PUT", name.manifest_url(),
                               data=json.dumps(manifest).encode(),
                               headers={"Content-Type": manifest.get(
                                   "mediaType", MANIFEST_MT)}):
                pass
        except urllib.error.HTTPError as e:
            raise RegistryError(f"manifest push failed: {e}") from e
        except urllib.error.URLError as e:
            raise RegistryError(f"registry unreachable: {e}") from e
        if progress:
            progress("success", 0, 0)
        return name
