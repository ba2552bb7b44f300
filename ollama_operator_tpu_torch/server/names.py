"""Model name parsing: [registry/][namespace/]name[:tag].

A copy of ``ollama_operator_tpu/server/names.py``: the resolution rules the
ollama CLI applies to a Model's image: bare names default to
registry.ollama.ai/library/<name>:latest, and an ``http://host:port/...``
prefix names a registry reached over plain HTTP.
"""

from __future__ import annotations

import dataclasses

DEFAULT_REGISTRY = "registry.ollama.ai"
DEFAULT_NAMESPACE = "library"
DEFAULT_TAG = "latest"


@dataclasses.dataclass(frozen=True)
class ModelName:
    registry: str = DEFAULT_REGISTRY
    namespace: str = DEFAULT_NAMESPACE
    name: str = ""
    tag: str = DEFAULT_TAG

    @staticmethod
    def parse(s: str) -> "ModelName":
        s = s.strip()
        scheme = ""
        if s.startswith("http://") or s.startswith("https://"):
            scheme, s = s.split("://", 1)
        tag = DEFAULT_TAG
        if ":" in s.rsplit("/", 1)[-1]:
            s, tag = s.rsplit(":", 1)
        parts = s.split("/")
        if len(parts) == 1:
            reg, ns, name = DEFAULT_REGISTRY, DEFAULT_NAMESPACE, parts[0]
        elif len(parts) == 2:
            reg, ns, name = DEFAULT_REGISTRY, parts[0], parts[1]
        else:
            reg, ns, name = parts[0], "/".join(parts[1:-1]), parts[-1]
        if scheme:
            reg = f"{scheme}://{reg}"
        return ModelName(reg, ns, name, tag)

    @property
    def short(self) -> str:
        """Display form: drops default registry/namespace."""
        base = self.name
        if self.namespace != DEFAULT_NAMESPACE:
            base = f"{self.namespace}/{base}"
        if self.registry != DEFAULT_REGISTRY:
            base = f"{self.registry}/{base}"
        return f"{base}:{self.tag}"

    @property
    def registry_host(self) -> str:
        return self.registry.split("://", 1)[-1]

    @property
    def base_url(self) -> str:
        if "://" in self.registry:
            return self.registry
        return f"https://{self.registry}"

    def manifest_url(self) -> str:
        return (f"{self.base_url}/v2/{self.namespace}/{self.name}"
                f"/manifests/{self.tag}")

    def blob_url(self, digest: str) -> str:
        return f"{self.base_url}/v2/{self.namespace}/{self.name}/blobs/{digest}"
