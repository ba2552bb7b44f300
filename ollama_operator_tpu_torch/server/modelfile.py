"""Modelfile parsing (the ollama model-definition DSL).

A copy of ``ollama_operator_tpu/server/modelfile.py``. Model images carry
the rendered layers (template/system/params); ``/api/show`` renders them
back into a Modelfile, and the parser accepts the textual form. Supported
commands: FROM, PARAMETER,
TEMPLATE, SYSTEM, LICENSE, ADAPTER, MESSAGE — values may be single-line or
triple-quoted blocks.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class Modelfile:
    from_: str = ""
    parameters: Dict[str, object] = dataclasses.field(default_factory=dict)
    template: Optional[str] = None
    system: Optional[str] = None
    license: Optional[str] = None
    adapter: Optional[str] = None
    messages: List[Tuple[str, str]] = dataclasses.field(default_factory=list)

    def render(self) -> str:
        out = [f"FROM {self.from_}"]
        for k, v in self.parameters.items():
            vs = v if not isinstance(v, list) else v
            if isinstance(vs, list):
                for item in vs:
                    out.append(f"PARAMETER {k} {item}")
            else:
                out.append(f"PARAMETER {k} {vs}")
        if self.template:
            out.append(f'TEMPLATE """{self.template}"""')
        if self.system:
            out.append(f'SYSTEM """{self.system}"""')
        if self.adapter:
            out.append(f"ADAPTER {self.adapter}")
        if self.license:
            out.append(f'LICENSE """{self.license}"""')
        return "\n".join(out) + "\n"


# parameter name → parser; repeatable params accumulate into lists
_NUM_PARAMS = {
    "temperature": float, "top_p": float, "min_p": float,
    "repeat_penalty": float, "presence_penalty": float,
    "frequency_penalty": float, "top_k": int, "seed": int,
    "num_ctx": int, "num_predict": int, "repeat_last_n": int,
    "num_keep": int, "num_gpu": int, "num_thread": int,
    "mirostat": int, "mirostat_eta": float, "mirostat_tau": float,
    "tfs_z": float, "typical_p": float,
}
_REPEATABLE = {"stop"}


def parse_parameter(key: str, raw: str):
    key = key.lower()
    if key in _NUM_PARAMS:
        return key, _NUM_PARAMS[key](raw)
    if raw.lower() in ("true", "false"):
        return key, raw.lower() == "true"
    if len(raw) >= 2 and raw[0] == raw[-1] and raw[0] in "\"'":
        raw = raw[1:-1]
    return key, raw


def parse_modelfile(text: str) -> Modelfile:
    mf = Modelfile()
    lines = text.splitlines()
    i = 0

    def read_value(first: str) -> str:
        nonlocal i
        v = first.strip()
        for quote in ('"""', "'''"):
            if v.startswith(quote):
                rest = v[len(quote):]
                if rest.endswith(quote) and len(rest) >= len(quote):
                    return rest[:-len(quote)]
                parts = [rest] if rest else []
                while i < len(lines):
                    ln = lines[i]
                    i += 1
                    if ln.rstrip().endswith(quote):
                        parts.append(ln.rstrip()[:-len(quote)])
                        return "\n".join(parts)
                    parts.append(ln)
                return "\n".join(parts)
        if len(v) >= 2 and v[0] == v[-1] and v[0] in "\"'":
            return v[1:-1]
        return v

    while i < len(lines):
        line = lines[i]
        i += 1
        stripped = line.strip()
        if not stripped or stripped.startswith("#"):
            continue
        cmd, _, rest = stripped.partition(" ")
        cmd = cmd.upper()
        if cmd == "FROM":
            mf.from_ = rest.strip()
        elif cmd == "PARAMETER":
            key, _, raw = rest.strip().partition(" ")
            k, v = parse_parameter(key, raw.strip())
            if k in _REPEATABLE:
                mf.parameters.setdefault(k, [])
                mf.parameters[k].append(v)
            else:
                mf.parameters[k] = v
        elif cmd == "TEMPLATE":
            mf.template = read_value(rest)
        elif cmd == "SYSTEM":
            mf.system = read_value(rest)
        elif cmd == "LICENSE":
            mf.license = read_value(rest)
        elif cmd == "ADAPTER":
            mf.adapter = rest.strip()
        elif cmd == "MESSAGE":
            role, _, content = rest.strip().partition(" ")
            mf.messages.append((role, read_value(content)))
        # unknown commands are ignored (forward compatibility)
    return mf


def params_json(mf: Modelfile) -> str:
    """The params layer content (application/vnd.ollama.image.params)."""
    return json.dumps(mf.parameters, sort_keys=True)
