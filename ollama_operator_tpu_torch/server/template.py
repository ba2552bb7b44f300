"""Go text/template subset interpreter for Ollama prompt templates.

A copy of ``ollama_operator_tpu/server/template.py``: the torch port keeps its own copy and imports
nothing of the JAX package.

Ollama model images carry a TEMPLATE layer written in Go's text/template
syntax; the reference inherits its rendering from the delegated ollama server
(SURVEY.md §2.2 "Modelfile semantics"). This implements the subset real
model templates use:

  {{ .Field }} {{ .A.B }}           field paths (dict lookup)
  {{- ... -}}                       whitespace trim markers
  {{ if EXPR }} … {{ else }} … {{ end }}
  {{ range EXPR }} … {{ end }}      (dot rebinds to the element)
  eq/ne/and/or/not, string literals "…", $last-style iteration helpers are
  NOT needed by the shipped templates we target (llama2, chatml, gemma,
  phi, mistral) — unsupported constructs raise TemplateError.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple


class TemplateError(ValueError):
    pass


_TOKEN_RE = re.compile(r"\{\{-?\s*(.*?)\s*-?\}\}", re.DOTALL)


def _lex(src: str) -> List[Tuple[str, str]]:
    """→ [("text", s) | ("action", expr)], with whitespace trims applied."""
    out: List[Tuple[str, str]] = []
    pos = 0
    for m in _TOKEN_RE.finditer(src):
        text = src[pos:m.start()]
        if m.group(0).startswith("{{-"):
            text = text.rstrip()
        if out and out[-1][0] == "trim_next":
            out.pop()
            text = text.lstrip()
        if text:
            out.append(("text", text))
        out.append(("action", m.group(1)))
        if m.group(0).endswith("-}}"):
            out.append(("trim_next", ""))
        pos = m.end()
    tail = src[pos:]
    if out and out[-1][0] == "trim_next":
        out.pop()
        tail = tail.lstrip()
    if tail:
        out.append(("text", tail))
    return out


# --- expression evaluation -------------------------------------------------

_STR_RE = re.compile(r'"((?:[^"\\]|\\.)*)"')


def _split_args(expr: str) -> List[str]:
    out, cur, depth, in_str = [], "", 0, False
    i = 0
    while i < len(expr):
        c = expr[i]
        if in_str:
            cur += c
            if c == "\\":
                cur += expr[i + 1]
                i += 2
                continue
            if c == '"':
                in_str = False
        elif c == '"':
            in_str = True
            cur += c
        elif c == "(":
            depth += 1
            cur += c
        elif c == ")":
            depth -= 1
            cur += c
        elif c.isspace() and depth == 0:
            if cur:
                out.append(cur)
                cur = ""
        else:
            cur += c
        i += 1
    if cur:
        out.append(cur)
    return out


def _truthy(v: Any) -> bool:
    return bool(v)


def _eval(expr: str, dot: Any) -> Any:
    expr = expr.strip()
    if expr.startswith("(") and expr.endswith(")"):
        return _eval(expr[1:-1], dot)
    m = _STR_RE.fullmatch(expr)
    if m:
        return m.group(1).replace('\\"', '"').replace("\\n", "\n")
    if expr == ".":
        return dot
    if expr.startswith("."):
        cur = dot
        for part in expr[1:].split("."):
            if not part:
                continue
            if isinstance(cur, dict):
                cur = cur.get(part, cur.get(part[0].lower() + part[1:], ""))
            else:
                cur = getattr(cur, part, "")
        return cur
    args = _split_args(expr)
    if len(args) > 1:
        fn, rest = args[0], [_eval(a, dot) for a in args[1:]]
        if fn == "eq":
            return all(r == rest[0] for r in rest[1:])
        if fn == "ne":
            return rest[0] != rest[1]
        if fn == "and":
            for r in rest:
                if not _truthy(r):
                    return r
            return rest[-1]
        if fn == "or":
            for r in rest:
                if _truthy(r):
                    return r
            return rest[-1]
        if fn == "not":
            return not _truthy(rest[0])
        if fn == "json":
            import json as _json
            return _json.dumps(rest[0])
        raise TemplateError(f"unsupported template function {fn!r}")
    if expr in ("true", "false"):
        return expr == "true"
    raise TemplateError(f"unsupported template expression {expr!r}")


# --- parse + render --------------------------------------------------------

class _Node:
    pass


class _Text(_Node):
    def __init__(self, s):
        self.s = s


class _Emit(_Node):
    def __init__(self, expr):
        self.expr = expr


class _If(_Node):
    def __init__(self, expr, body, orelse):
        self.expr, self.body, self.orelse = expr, body, orelse


class _Range(_Node):
    def __init__(self, expr, body):
        self.expr, self.body = expr, body


def _parse(tokens: List[Tuple[str, str]], i: int = 0,
           until: Optional[set] = None) -> Tuple[List[_Node], int, str]:
    nodes: List[_Node] = []
    while i < len(tokens):
        kind, val = tokens[i]
        if kind == "text":
            nodes.append(_Text(val))
            i += 1
            continue
        word = val.split(None, 1)[0] if val else ""
        if until and word in until:
            return nodes, i, word
        if word == "if":
            node, i = _parse_if(val.split(None, 1)[1], tokens, i + 1)
            nodes.append(node)
            i += 1  # past the matching end
        elif word == "range":
            body, i, _ = _parse(tokens, i + 1, {"end"})
            nodes.append(_Range(val.split(None, 1)[1], body))
            i += 1
        elif word in ("end", "else"):
            raise TemplateError(f"unexpected {{{{ {word} }}}}")
        else:
            nodes.append(_Emit(val))
            i += 1
    return nodes, i, ""


def _parse_if(expr: str, tokens: List[Tuple[str, str]], i: int
              ) -> Tuple[_If, int]:
    """Parse an if-chain starting just after its `if EXPR` action. Returns
    the node and the index of the matching `end` token (chained else-ifs
    share one `end`)."""
    body, i, stop = _parse(tokens, i, {"else", "end"})
    orelse: List[_Node] = []
    if stop == "else":
        rest = tokens[i][1].split(None, 1)
        if len(rest) > 1 and rest[1].lstrip().startswith("if"):
            sub_expr = rest[1].lstrip()[2:].strip()
            inner, i = _parse_if(sub_expr, tokens, i + 1)
            orelse = [inner]
        else:
            orelse, i, _ = _parse(tokens, i + 1, {"end"})
    return _If(expr, body, orelse), i


def _render(nodes: List[_Node], dot: Any, out: List[str]):
    for n in nodes:
        if isinstance(n, _Text):
            out.append(n.s)
        elif isinstance(n, _Emit):
            v = _eval(n.expr, dot)
            if isinstance(v, (dict, list)):
                # Go renders structs with fmt verbs; models are trained on
                # JSON tool specs, so emit maps/lists as JSON (tool use)
                import json as _json
                out.append(_json.dumps(v))
            else:
                out.append("" if v is None else str(v))
        elif isinstance(n, _If):
            if _truthy(_eval(n.expr, dot)):
                _render(n.body, dot, out)
            else:
                _render(n.orelse, dot, out)
        elif isinstance(n, _Range):
            seq = _eval(n.expr, dot) or []
            for item in seq:
                _render(n.body, item, out)


class Template:
    def __init__(self, src: str):
        self.src = src
        tokens = [t for t in _lex(src) if t[0] != "trim_next"]
        self.nodes, _, _ = _parse(tokens)

    def render(self, **ctx: Any) -> str:
        # Go templates address fields capitalised; accept both spellings
        dot = dict(ctx)
        for k in list(dot):
            dot[k[0].upper() + k[1:]] = dot[k]
        out: List[str] = []
        _render(self.nodes, dot, out)
        return "".join(out)


# default template when a model image carries none (matches ollama's
# behaviour of passing the prompt through)
DEFAULT_TEMPLATE = "{{ if .System }}{{ .System }}\n\n{{ end }}{{ .Prompt }}"
