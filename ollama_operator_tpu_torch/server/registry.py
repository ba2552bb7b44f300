"""Ollama registry client + local model store.

The parts of ``ollama_operator_tpu/server/registry.py`` that pulling needs:
the media-type constants, ``ModelStore`` and ``RegistryClient``'s
``fetch_manifest`` and ``pull``. The client speaks the registry protocol
that `ollama pull` speaks:

  GET  /v2/<ns>/<name>/manifests/<tag>   (docker manifest v2 JSON)
  GET  /v2/<ns>/<name>/blobs/<digest>    (content-addressed layers)

Layer mediaTypes: application/vnd.ollama.image.{model,template,system,
params,license,adapter,projector} — the model layer is the GGUF file.

The on-disk layout is ollama's, byte for byte the JAX package's, so one
shared volume serves both packages (pull once, every replica mmap-shares):

  <root>/blobs/sha256-<hex>
  <root>/manifests/<registry>/<ns>/<name>/<tag>

Downloads stream to a unique .partial file and are verified against the
digest before being atomically published; interrupted pulls resume via HTTP
Range. Pushing, blob uploads and local creation are not ported yet.
"""

from __future__ import annotations

import hashlib
import json
import os
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
MANIFEST_ACCEPT = ("application/vnd.docker.distribution.manifest.v2+json, "
                   "application/vnd.oci.image.manifest.v1+json")

# (status, completed, total, digest=None) — digest set on blob progress so
# clients (the ollama CLI keys per-layer progress bars on it) can track layers
ProgressCb = Callable[..., None]


class RegistryError(RuntimeError):
    pass


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
