"""JSON-Schema-constrained decoding (Ollama ``format: {…}``).

A copy of ``ollama_operator_tpu/ops/schema.py`` with its Python mask fill
only (the native fill of ``native/grammar.cpp`` is not ported). Sampling
stays on the device as in the generic JSON mode (``ops/constrain.py``): the
host advances a byte automaton and uploads one packed mask per step.

The automaton is a **skeleton machine**: the schema compiles to a node
tree —

  ("lit",  bytes)            fixed structural bytes ('{"name":', ',', '}')
  ("leaf", kind)             a typed value hole, validated by the generic
                             byte PDA with kind restrictions (string /
                             number / integer / boolean / null / any)
  ("seq",  (children, ...))  object skeleton: literals + holes in the
                             schema's property order
  ("enum", (alts, ...))      one of several literal JSON values
  ("arr",  item, min1)       '[' item (',' item)* ']' (or empty)
  ("alt",  (children, ...))  anyOf/oneOf alternation — expanded at push
                             time into one NFA branch per child
  ("irange", lo, hi)         integer hole with bounds: a digit-count DFA
                             decides which prefixes can still land in
                             [lo, hi] (None = unbounded side)

and the machine state is a SET of stacks of (node, position) frames — a
recursive-descent acceptor driven one byte at a time (alternation makes
it an NFA; branches prune as bytes disambiguate), so token pieces that
cross hole/literal boundaries are handled exactly.

Unsupported schema constructs (patternProperties, additionalProperties
schemas, string length/pattern, float ranges, multipleOf, …) make
``compile_schema`` return None and the caller falls back to generic JSON
mode with a warning — never a silently wrong constraint.

Masks are cached per (schema, machine state) on the compiled Schema
object, which the server shares across requests with the same schema.
A 256-bucket first-byte index keeps mask fills cheap for the (many)
structural states whose next byte is nearly determined; hole-interior
states cache by the PDA's abstract stack-suffix key, so each DISTINCT
abstract state pays one Python vocabulary sweep (amortised across the
response and across requests sharing the schema). Schema constraints
always run on host masks: their states are not the generic PDA's, so no
device grammar table serves them.
"""

from __future__ import annotations

import json
from collections import OrderedDict
from threading import Lock
from typing import List, Optional, Tuple

import numpy as np

from .constrain import (INITIAL_STATE, M_AFTER, TokenTable,
                        advance_byte, eos_ok)

Kind = str
Node = Tuple  # see module docstring

_START_BYTES = {
    "string": b'"',
    "number": b"-0123456789",
    "integer": b"-0123456789",
    "boolean": b"tf",
    "null": b"n",
    "any": None,               # unrestricted
}
_INT_FORBIDDEN = frozenset(b".eE")


# ---------------------------------------------------------------------------
# schema → node tree
# ---------------------------------------------------------------------------

# annotation-only keywords that never change validation
_BENIGN_KEYS = {"title", "description", "default", "examples", "$schema",
                "$id", "$comment", "deprecated", "readOnly", "writeOnly"}


def _only_keys(schema: dict, allowed: frozenset) -> bool:
    """WHITELIST check: any keyword we don't implement (exclusiveMinimum,
    multipleOf, prefixItems, …) must route to the generic-JSON fallback —
    compiling past it would silently under-constrain."""
    return not (set(schema) - allowed - _BENIGN_KEYS)


def _compile_node(schema) -> Optional[Node]:
    if not isinstance(schema, dict):
        return None
    if "anyOf" in schema or "oneOf" in schema:
        # oneOf's exclusivity is unenforceable token-by-token (a prefix can
        # be extended into several alternatives); constraining to the anyOf
        # union is the sound over-approximation every grammar sampler makes
        key = "anyOf" if "anyOf" in schema else "oneOf"
        if not _only_keys(schema, frozenset({key})):
            return None
        alts = schema[key]
        if not isinstance(alts, list) or not alts:
            return None
        children = tuple(_compile_node(a) for a in alts)
        if any(c is None for c in children):
            return None
        return ("alt", children)
    if "enum" in schema:
        if not _only_keys(schema, frozenset({"enum", "type"})):
            return None
        try:
            alts = tuple(json.dumps(v, separators=(",", ":"),
                                    ensure_ascii=False).encode()
                         for v in schema["enum"])
        except (TypeError, ValueError):
            return None
        return ("enum", alts) if alts else None
    if "const" in schema:
        if not _only_keys(schema, frozenset({"const", "type"})):
            return None
        try:
            return ("enum", (json.dumps(schema["const"],
                                        separators=(",", ":"),
                                        ensure_ascii=False).encode(),))
        except (TypeError, ValueError):
            return None
    t = schema.get("type")
    if isinstance(t, list):
        return None
    if t == "object" or (t is None and "properties" in schema):
        if not _only_keys(schema, frozenset(
                {"type", "properties", "required", "additionalProperties"})):
            return None
        props = schema.get("properties")
        if not isinstance(props, dict) or not props:
            return None
        if schema.get("additionalProperties") not in (None, False):
            return None
        req = schema.get("required")
        if req is not None and set(req) != set(props):
            # optional properties would need alternation; keep v1 exact
            return None
        parts: List[Node] = []
        for i, (key, sub) in enumerate(props.items()):
            child = _compile_node(sub)
            if child is None:
                return None
            prefix = ("{" if i == 0 else ",") + json.dumps(key) + ":"
            parts.append(("lit", prefix.encode()))
            parts.append(child)
        parts.append(("lit", b"}"))
        return ("seq", tuple(parts))
    if t == "array":
        if not _only_keys(schema, frozenset({"type", "items", "minItems"})):
            return None
        items = schema.get("items")
        child = _compile_node(items) if items is not None else ("leaf", "any")
        if child is None:
            return None
        min_items = schema.get("minItems", 0)
        # (maxItems never reaches here — it fails the _only_keys whitelist
        # above and falls back to the generic JSON PDA)
        if min_items not in (0, 1):
            return None
        return ("arr", child, int(min_items))
    if t == "integer" and not _only_keys(schema, frozenset({"type"})):
        # bounded integers: minimum/maximum (and their exclusive forms)
        # compile to the digit-count DFA ("irange"); anything further
        # falls back
        if not _only_keys(schema, frozenset(
                {"type", "minimum", "maximum",
                 "exclusiveMinimum", "exclusiveMaximum"})):
            return None
        lo, hi = schema.get("minimum"), schema.get("maximum")
        xlo, xhi = schema.get("exclusiveMinimum"), \
            schema.get("exclusiveMaximum")
        bounds = [b for b in (lo, hi, xlo, xhi) if b is not None]
        if not all(isinstance(b, int) and not isinstance(b, bool)
                   for b in bounds):
            return None            # float bounds on integers: fall back
        if xlo is not None:
            lo = xlo + 1 if lo is None else max(lo, xlo + 1)
        if xhi is not None:
            hi = xhi - 1 if hi is None else min(hi, xhi - 1)
        if lo is not None and hi is not None and lo > hi:
            return None            # unsatisfiable: nothing could ever emit
        return ("irange", lo, hi)
    if not _only_keys(schema, frozenset({"type"})):
        return None
    if t in ("string", "number", "integer", "boolean", "null"):
        return ("leaf", t)
    if t is None:
        return ("leaf", "any")
    return None


def compile_schema(schema) -> Optional["Schema"]:
    """Schema dict → Schema machine, or None when a construct is outside
    the supported subset (caller falls back to generic JSON mode)."""
    root = _compile_node(schema)
    if root is None:
        return None
    return Schema(root)


# ---------------------------------------------------------------------------
# the skeleton machine
# ---------------------------------------------------------------------------

def _irange_viable(lo, hi, sign: int, v: int, k: int) -> bool:
    """Can the k-digit magnitude ``v`` (sign ``sign``), extended by zero or
    more digits, still land in [lo, hi] (None = unbounded side)? The
    digit-count DFA behind ("irange", lo, hi): at most ~19 interval checks
    per byte, no enumeration."""
    def fits(a, b2):
        vlo, vhi = (a, b2) if sign >= 0 else (-b2, -a)
        return (hi is None or vlo <= hi) and (lo is None or vhi >= lo)

    if fits(v, v):
        return True
    if v == 0:
        return False                    # leading zero: no extensions
    if sign >= 0:
        if hi is None:
            return True                 # magnitude grows past any lo
        limit = len(str(hi)) if hi > 0 else k
    else:
        if lo is None:
            return True
        limit = len(str(-lo)) if lo < 0 else k
    for m in range(k + 1, limit + 1):
        scale = 10 ** (m - k)
        if fits(v * scale, v * scale + scale - 1):
            return True
    return False


def _irange_done(node: Node, sub) -> bool:
    """Current irange digits form a complete in-range integer."""
    sign, v, k = sub
    if k == 0:
        return False
    val = v if sign >= 0 else -v
    return ((node[1] is None or val >= node[1])
            and (node[2] is None or val <= node[2]))


def _init_sub(node: Node):
    tag = node[0]
    if tag == "lit":
        return 0
    if tag == "leaf":
        return INITIAL_STATE
    if tag == "enum":
        return (0, tuple(range(len(node[1]))), False)
    if tag == "arr":
        return 0
    if tag == "irange":
        return (0, 0, 0)                # (sign, magnitude, n_digits)
    raise AssertionError(tag)


def _push_multi(stack: tuple, node: Node) -> List[tuple]:
    """All stacks reachable by pushing ``node``: seq heads are descended,
    alt nodes expand into one branch per alternative (the NFA split)."""
    out: List[tuple] = []
    work = [(list(stack), node)]
    while work:
        st, n = work.pop()
        tag = n[0]
        if tag == "seq":
            st.append((n, 0))
            work.append((st, n[1][0]))
        elif tag == "alt":
            for child in n[1]:
                work.append((list(st), child))
        else:
            st.append((n, _init_sub(n)))
            out.append(tuple(st))
    return out


def _completed_child(stack: tuple) -> List[tuple]:
    """Top frame finished and was popped; advance ancestors (possibly
    completing them too) and push the next consumer if any. Returns all
    resulting stacks (alternation in a following consumer can split)."""
    st = list(stack)
    while st:
        node, sub = st[-1]
        tag = node[0]
        if tag == "seq":
            nxt = sub + 1
            if nxt == len(node[1]):
                st.pop()
                continue
            st[-1] = (node, nxt)
            return _push_multi(tuple(st), node[1][nxt])
        if tag == "arr":
            st[-1] = (node, 3)          # after an item: ',' or ']'
            return [tuple(st)]
        raise AssertionError(tag)
    return [tuple(st)]


def machine_init(root: Node) -> tuple:
    """Initial NFA state: a tuple of stacks (alternation at the root
    yields several)."""
    return tuple(_push_multi((), root))


def _advance_stack(root: Node, stack: tuple, b: int) -> List[tuple]:
    """One byte through a single stack; returns every successor stack
    (alternation pushes and lazy closes can split), [] = rejected."""
    if not stack:
        return []                           # schema complete: EOS only
    st = list(stack)
    node, sub = st[-1]
    tag = node[0]
    if tag == "lit":
        data = node[1]
        if data[sub] != b:
            return []
        sub += 1
        if sub == len(data):
            st.pop()
            return _completed_child(tuple(st))
        st[-1] = (node, sub)
        return [tuple(st)]
    if tag == "leaf":
        kind = node[1]
        allowed = True
        if sub == INITIAL_STATE:
            start = _START_BYTES[kind]
            allowed = start is None or b in start
        if allowed and kind == "integer" and b in _INT_FORBIDDEN:
            allowed = False
        ns = advance_byte(sub, b) if allowed else None
        if ns is not None:
            if len(ns) == 4 and ns[0] == M_AFTER:
                st.pop()                    # value definitely closed
                return _completed_child(tuple(st))
            st[-1] = (node, ns)
            return [tuple(st)]
        if eos_ok(sub):                     # lazy close (numbers)
            st.pop()
            out: List[tuple] = []
            for cs in _completed_child(tuple(st)):
                out.extend(_advance_stack(root, cs, b))   # redispatch b
            return out
        return []
    if tag == "enum":
        off, viable, _ = sub
        nv = tuple(i for i in viable if off < len(node[1][i])
                   and node[1][i][off] == b)
        if not nv:
            return []
        off += 1
        ext = tuple(i for i in nv if len(node[1][i]) > off)
        results: List[tuple] = []
        if ext:
            st2 = list(st)
            st2[-1] = (node, (off, ext, False))
            results.append(tuple(st2))
        if any(len(node[1][i]) == off for i in nv):
            st2 = list(st)
            st2.pop()                       # an alternative fully matched
            results.extend(_completed_child(tuple(st2)))
        return results
    if tag == "arr":
        if sub == 0:
            if b != ord("["):
                return []
            st[-1] = (node, 1)
            return [tuple(st)]
        if sub == 1:                        # first item or ']'
            if b == ord("]") and node[2] == 0:
                st.pop()
                return _completed_child(tuple(st))
            st[-1] = (node, 2)
            out = []
            for ps in _push_multi(tuple(st), node[1]):
                out.extend(_advance_stack(root, ps, b))   # redispatch b
            return out
        if sub == 3:                        # after an item
            if b == ord("]"):
                st.pop()
                return _completed_child(tuple(st))
            if b == ord(","):
                st[-1] = (node, 2)
                return _push_multi(tuple(st), node[1])
            return []
        return []                           # sub == 2 never sits on top
    if tag == "irange":
        sign, v, k = sub
        lo, hi = node[1], node[2]
        if 0x30 <= b <= 0x39:
            d = b - 0x30
            if k == 0:
                nv_, nk = d, 1
            elif v == 0:
                return []                   # leading zero can't extend
            else:
                nv_, nk = v * 10 + d, k + 1
            s_eff = sign if sign != 0 else 1
            if not _irange_viable(lo, hi, s_eff, nv_, nk):
                return []
            st[-1] = (node, (s_eff, nv_, nk))
            return [tuple(st)]
        if b == 0x2D and sign == 0 and k == 0:            # '-'
            if any(_irange_viable(lo, hi, -1, d, 1) for d in range(10)):
                st[-1] = (node, (-1, 0, 0))
                return [tuple(st)]
            return []
        if _irange_done(node, sub):         # delimiter closes the integer
            st.pop()
            out = []
            for cs in _completed_child(tuple(st)):
                out.extend(_advance_stack(root, cs, b))   # redispatch b
            return out
        return []
    raise AssertionError(tag)


def machine_advance(root: Node, state: tuple, b: int) -> Optional[tuple]:
    """One byte through the NFA; None = rejected. ``state`` is a tuple of
    stacks, each an immutable tuple of (node, sub) frames."""
    out: List[tuple] = []
    seen = set()
    for stack in state:
        for ns in _advance_stack(root, stack, b):
            if ns not in seen:
                seen.add(ns)
                out.append(ns)
    return tuple(out) if out else None


def _stack_eos_ok(stack: tuple) -> bool:
    """One stack closable without more bytes? Only lazily-closing holes
    (numbers, bounded integers) can sit open at EOS — everything else
    completes eagerly on its final byte, leaving the empty stack."""
    if not stack:
        return True                         # schema complete
    st = list(stack)
    node, sub = st[-1]
    tag = node[0]
    closable = ((tag == "leaf" and eos_ok(sub))
                or (tag == "irange" and _irange_done(node, sub)))
    if not closable:
        return False
    st.pop()
    # ancestors must all be at their last position — no new consumers
    while st:
        pn, ps = st[-1]
        if pn[0] == "seq" and ps + 1 == len(pn[1]):
            st.pop()
            continue
        return False
    return True


def machine_eos_ok(state: tuple) -> bool:
    """EOS legal iff SOME branch can close without more bytes."""
    return any(_stack_eos_ok(s) for s in state)


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------

class Schema:
    """Compiled schema + per-state mask cache (shared across requests)."""

    def __init__(self, root: Node):
        self.root = root
        self._masks: OrderedDict = OrderedDict()
        self._lock = Lock()
        self._cap = 8192

    def _state_key(self, table: TokenTable, state: tuple):
        # leaf PDA states use constrain.py's abstract stack-suffix key: a
        # token of max_len bytes can pop at most max_len containers, so
        # deeper "any"-hole nesting cannot change any token's acceptance
        # — without this, '[[[…' would mint (and full-vocab-sweep) a
        # fresh state per depth. The NFA state is a SET of stacks, so the
        # key is order-insensitive (frozenset).
        def sub_key(n, s):
            if n[0] == "leaf" and isinstance(s, bytes):
                return s[:4] + s[4:][-table.max_len:]
            return s
        return (id(table),
                frozenset(tuple((id(n), sub_key(n, s)) for n, s in stack)
                          for stack in state))

    def mask_for(self, table: TokenTable, state: tuple) -> np.ndarray:
        key = self._state_key(table, state)
        with self._lock:
            m = self._masks.get(key)
            if m is not None:
                self._masks.move_to_end(key)
                return m
        # the Python sweep with the first-byte prefilter
        first = bytes(b for b in range(256)
                      if machine_advance(self.root, state, b) is not None)
        idx = _byte_index(table)
        if len(first) <= 32:
            cand: List[int] = []
            for b in first:
                cand.extend(idx[b])
        else:
            cand = range(table.n_vocab)
        mask = np.zeros(table.n_words, np.uint32)
        for tid in cand:
            piece = table.pieces[tid]
            if not piece:
                continue
            st = state
            for b in piece:
                st = machine_advance(self.root, st, b)
                if st is None:
                    break
            if st is not None:
                mask[tid >> 5] |= np.uint32(1 << (tid & 31))
        if machine_eos_ok(state):
            if not any(machine_advance(self.root, state, b) is not None
                       for b in range(256)):
                mask = table._eog_packed.copy()   # nothing else is legal
            else:
                mask = mask | table._eog_packed
        with self._lock:
            self._masks[key] = mask
            self._masks.move_to_end(key)
            while len(self._masks) > self._cap:
                self._masks.popitem(last=False)
        return mask


_byte_index_lock = Lock()


def _byte_index(table: TokenTable) -> List[List[int]]:
    """First-byte → token ids, built once and stored ON the table (its
    lifetime owns the index; an id()-keyed global would leak across
    model unloads and could serve a recycled address the wrong vocab)."""
    idx = getattr(table, "_schema_byte_index", None)
    if idx is None:
        with _byte_index_lock:
            idx = getattr(table, "_schema_byte_index", None)
            if idx is None:
                idx = [[] for _ in range(256)]
                for tid, piece in enumerate(table.pieces):
                    if piece:
                        idx[piece[0]].append(tid)
                table._schema_byte_index = idx
    return idx


class SchemaConstraint:
    """Per-request schema state; same interface as JsonConstraint."""

    def __init__(self, schema: Schema, table: TokenTable):
        self.schema = schema
        self.table = table
        self.state: Optional[tuple] = machine_init(schema.root)

    @classmethod
    def for_tokenizer(cls, schema: Schema, tok) -> "SchemaConstraint":
        return cls(schema, TokenTable.for_tokenizer(tok))

    def mask_row(self) -> np.ndarray:
        assert self.state is not None, "constraint already dead"
        return self.schema.mask_for(self.table, self.state)

    def advance(self, tid: int) -> bool:
        if self.state is None:
            return False
        piece = (self.table.pieces[tid]
                 if 0 <= tid < self.table.n_vocab else b"")
        if not piece:
            return False
        st = self.state
        for b in piece:
            st = machine_advance(self.schema.root, st, b)
            if st is None:
                break
        self.state = st
        return st is not None

    @property
    def done(self) -> bool:
        return self.state is not None and machine_eos_ok(self.state)
