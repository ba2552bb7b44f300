"""Tool calling (function calling) for /api/chat and /v1/chat/completions.

A copy of ``ollama_operator_tpu/server/tools.py``. Requests carry
OpenAI-shaped ``tools``, the model's Go template renders them into the
prompt (templates access capitalized fields — ``.Tools``,
``.Function.Name`` …), and the model's textual output is parsed back into
structured ``tool_calls`` when it emits a JSON invocation.

This module owns the two data transformations:
- ``to_template_tools`` / ``to_template_tool_calls``: OpenAI wire shape →
  Go-template shape (capitalized keys) for server/template.py.
- ``parse_tool_calls``: model output text → [{"function": {"name", "arguments"}}]
  (handles a bare object, a list of objects, ollama's "parameters" alias,
  and JSON embedded after leading prose).
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Optional


def to_template_tools(tools: List[Dict]) -> List[Dict]:
    """Normalised LOWERCASE keys: the template engine's field lookup falls
    back from ``.Function.Name`` to ``function``/``name``, and ``json``
    emission must produce the wire-shaped JSON models were trained on."""
    out = []
    for t in tools or []:
        fn = t.get("function") or {}
        out.append({
            "type": t.get("type", "function"),
            "function": {
                "name": fn.get("name", ""),
                "description": fn.get("description", ""),
                "parameters": fn.get("parameters") or {},
            },
        })
    return out


def to_template_tool_calls(calls: List[Dict]) -> List[Dict]:
    out = []
    for c in calls or []:
        fn = c.get("function") or {}
        args = fn.get("arguments")
        if isinstance(args, str):
            try:
                args = json.loads(args)
            except json.JSONDecodeError:
                pass
        out.append({"function": {"name": fn.get("name", ""),
                                 "arguments": args or {}}})
    return out


def _as_call(obj: Any) -> Optional[Dict]:
    """One parsed JSON value → a tool call dict, or None."""
    if not isinstance(obj, dict):
        return None
    name = obj.get("name")
    args = obj.get("arguments", obj.get("parameters"))
    if not isinstance(name, str) or not name:
        return None
    if args is None or not isinstance(args, dict):
        return None
    return {"function": {"name": name, "arguments": args}}


def _json_candidates(text: str):
    """Yield (value, start, end) for every decodable JSON span in
    ``text``: the whole string first, then brace/bracket-delimited spans
    between prose."""
    dec = json.JSONDecoder()
    s = text
    try:
        yield json.loads(s), 0, len(s)
        return
    except json.JSONDecodeError:
        pass
    i = 0
    while i < len(s):
        if s[i] in "[{":
            try:
                val, end = dec.raw_decode(s, i)
                yield val, i, end
                i = end
                continue
            except json.JSONDecodeError:
                pass
        i += 1


def split_tool_calls(text: str):
    """Model output → (tool calls, remaining prose).

    EVERY JSON span that decodes to tool invocations contributes calls
    (models emit parallel calls as separate objects); spans that aren't
    invocations, and all non-JSON text, stay in the prose remainder."""
    calls: List[Dict] = []
    keep: List[str] = []
    pos = 0
    for val, start, end in _json_candidates(text):
        items = val if isinstance(val, list) else [val]
        found = [c for c in (_as_call(x) for x in items) if c]
        if found and len(found) == len(items):
            calls.extend(found)
            keep.append(text[pos:start])
            pos = end
    keep.append(text[pos:])
    return calls, "".join(keep).strip()


def parse_tool_calls(text: str) -> List[Dict]:
    """Model output → tool calls ([] when the output is ordinary text)."""
    return split_tool_calls(text)[0]
