"""Grammar-constrained decoding: the Ollama ``format: "json"`` option.

A copy of ``ollama_operator_tpu/ops/constrain.py`` with its Python mask
path only (the native mask fill of ``native/grammar.cpp`` is not ported).
Sampling stays on the device: the grammar contributes one packed ``uint32``
bitmask per slot that the decode step unpacks and applies to the logits
(``runtime/engine.py``). The host advances a byte-level JSON pushdown
automaton with each sampled token and uploads the next mask, a
[B, ceil(V/32)] transfer, not a logits download.

Pieces:
- a byte-level PDA over a *packed state* (``bytes``): mode/aux/key flag +
  one byte per open container.
- ``TokenTable``: per-tokenizer token bytes, and a mask cache keyed by an
  *abstract* state (the stack suffix a token of ``max_len`` bytes could
  possibly touch; exact, see ``_cache_key``). A novel state's mask is a
  sweep of the whole vocabulary in Python.
- ``GrammarTable``: the reachable states (up to a cap) as a dense mask
  table and a token transition table, so that the decode step can advance
  the automaton on the device.
- ``JsonConstraint``: per-request PDA state; ``mask_row()`` → packed mask,
  ``advance(tid)`` → feed the sampled token.

EOS is allowed exactly when the JSON value is complete at depth 0; once
complete, *only* EOS is allowed, which forces generation to stop instead of
trailing whitespace forever.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Iterable, List, Optional, Sequence

import numpy as np

# --- packed PDA state --------------------------------------------------------
# state = bytes([mode, aux1, aux2, key_flag]) + stack (one byte per open
# container, CTX_OBJ/CTX_ARR, top of stack = last byte)

M_VALUE = 0       # expecting a value
M_ARR_FIRST = 1   # expecting a value or ']' (right after '[')
M_KEY_FIRST = 2   # expecting '"' (object key) or '}' (right after '{')
M_KEY = 3         # expecting '"' (object key, after ',')
M_COLON = 4       # expecting ':'
M_STR = 5         # inside a string (key_flag: 1 = object key)
M_ESC = 6         # after '\'
M_HEX = 7         # inside \uXXXX (aux1 = hex digits remaining)
M_NUM = 8         # inside a number (aux1 = numstate)
M_LIT = 9         # inside true/false/null (aux1 = literal id, aux2 = pos)
M_AFTER = 10      # after a complete value

CTX_OBJ, CTX_ARR = 1, 2

NS_MINUS, NS_ZERO, NS_INT, NS_DOT, NS_FRAC, NS_E, NS_ESIGN, NS_EXP = range(8)
_NS_TERMINAL = frozenset((NS_ZERO, NS_INT, NS_FRAC, NS_EXP))

_LITERALS = (b"true", b"false", b"null")
_WS = frozenset(b" \t\n\r")
_HEXD = frozenset(b"0123456789abcdefABCDEF")
_ESCAPES = frozenset(b'"\\/bfnrt')

INITIAL_STATE = bytes((M_VALUE, 0, 0, 0))


def _start_value(b: int, stack: bytes) -> Optional[bytes]:
    """Value-start byte → new packed state, or None if not a value start.

    Depth is deliberately unbounded (1 byte per open container, and a
    request can open at most num_predict containers) — a depth cap would
    make token acceptance depend on the depth itself and break the
    stack-suffix mask cache (TokenTable._cache_key)."""
    if b == 0x7B:  # {
        return bytes((M_KEY_FIRST, 0, 0, 0)) + stack + bytes((CTX_OBJ,))
    if b == 0x5B:  # [
        return bytes((M_ARR_FIRST, 0, 0, 0)) + stack + bytes((CTX_ARR,))
    if b == 0x22:  # "
        return bytes((M_STR, 0, 0, 0)) + stack
    if b == 0x2D:  # -
        return bytes((M_NUM, NS_MINUS, 0, 0)) + stack
    if b == 0x30:  # 0
        return bytes((M_NUM, NS_ZERO, 0, 0)) + stack
    if 0x31 <= b <= 0x39:
        return bytes((M_NUM, NS_INT, 0, 0)) + stack
    if b == 0x74:  # t
        return bytes((M_LIT, 0, 1, 0)) + stack
    if b == 0x66:  # f
        return bytes((M_LIT, 1, 1, 0)) + stack
    if b == 0x6E:  # n
        return bytes((M_LIT, 2, 1, 0)) + stack
    return None


def _after_value(b: int, stack: bytes) -> Optional[bytes]:
    """One byte in M_AFTER → new packed state, or None."""
    if b in _WS:
        return bytes((M_AFTER, 0, 0, 0)) + stack
    if not stack:
        return None
    top = stack[-1]
    if top == CTX_OBJ:
        if b == 0x2C:  # ,
            return bytes((M_KEY, 0, 0, 0)) + stack
        if b == 0x7D:  # }
            return bytes((M_AFTER, 0, 0, 0)) + stack[:-1]
    else:  # CTX_ARR
        if b == 0x2C:
            return bytes((M_VALUE, 0, 0, 0)) + stack
        if b == 0x5D:  # ]
            return bytes((M_AFTER, 0, 0, 0)) + stack[:-1]
    return None


def advance_byte(state: bytes, b: int) -> Optional[bytes]:
    """Feed one byte to the PDA; returns the new packed state or None."""
    mode, aux1, aux2, key = state[0], state[1], state[2], state[3]
    stack = state[4:]
    if mode == M_VALUE:
        if b in _WS:
            return state
        return _start_value(b, stack)
    if mode == M_ARR_FIRST:
        if b in _WS:
            return state
        if b == 0x5D:  # ]
            return bytes((M_AFTER, 0, 0, 0)) + stack[:-1]
        return _start_value(b, stack)
    if mode == M_KEY_FIRST:
        if b in _WS:
            return state
        if b == 0x22:
            return bytes((M_STR, 0, 0, 1)) + stack
        if b == 0x7D:  # }
            return bytes((M_AFTER, 0, 0, 0)) + stack[:-1]
        return None
    if mode == M_KEY:
        if b in _WS:
            return state
        if b == 0x22:
            return bytes((M_STR, 0, 0, 1)) + stack
        return None
    if mode == M_COLON:
        if b in _WS:
            return state
        if b == 0x3A:  # :
            return bytes((M_VALUE, 0, 0, 0)) + stack
        return None
    if mode == M_STR:
        if b == 0x22:  # closing quote
            if key:
                return bytes((M_COLON, 0, 0, 0)) + stack
            return bytes((M_AFTER, 0, 0, 0)) + stack
        if b == 0x5C:  # backslash
            return bytes((M_ESC, 0, 0, key)) + stack
        if b < 0x20:   # raw control bytes are invalid in JSON strings
            return None
        return state
    if mode == M_ESC:
        if b in _ESCAPES:
            return bytes((M_STR, 0, 0, key)) + stack
        if b == 0x75:  # u
            return bytes((M_HEX, 4, 0, key)) + stack
        return None
    if mode == M_HEX:
        if b in _HEXD:
            if aux1 == 1:
                return bytes((M_STR, 0, 0, key)) + stack
            return bytes((M_HEX, aux1 - 1, 0, key)) + stack
        return None
    if mode == M_NUM:
        ns = aux1
        if 0x30 <= b <= 0x39:  # digit
            nxt = {NS_MINUS: NS_ZERO if b == 0x30 else NS_INT,
                   NS_INT: NS_INT, NS_DOT: NS_FRAC, NS_FRAC: NS_FRAC,
                   NS_E: NS_EXP, NS_ESIGN: NS_EXP, NS_EXP: NS_EXP}.get(ns)
            if ns == NS_ZERO:  # leading zero: no more int digits
                nxt = None
            if nxt is None:
                return None
            return bytes((M_NUM, nxt, 0, 0)) + stack
        if b == 0x2E and ns in (NS_ZERO, NS_INT):  # .
            return bytes((M_NUM, NS_DOT, 0, 0)) + stack
        if b in (0x65, 0x45) and ns in (NS_ZERO, NS_INT, NS_FRAC):  # e E
            return bytes((M_NUM, NS_E, 0, 0)) + stack
        if b in (0x2B, 0x2D) and ns == NS_E:  # + -
            return bytes((M_NUM, NS_ESIGN, 0, 0)) + stack
        if ns in _NS_TERMINAL:  # delimiter terminates the number
            return _after_value(b, stack)
        return None
    if mode == M_LIT:
        lit = _LITERALS[aux1]
        if aux2 < len(lit) and b == lit[aux2]:
            if aux2 + 1 == len(lit):
                return bytes((M_AFTER, 0, 0, 0)) + stack
            return bytes((M_LIT, aux1, aux2 + 1, 0)) + stack
        return None
    if mode == M_AFTER:
        return _after_value(b, stack)
    return None


def advance_bytes(state: bytes, data: bytes) -> Optional[bytes]:
    for b in data:
        state = advance_byte(state, b)
        if state is None:
            return None
    return state


def eos_ok(state: bytes) -> bool:
    """EOS is legal iff a complete JSON value sits at depth 0."""
    if len(state) > 4:  # open containers
        return False
    mode, aux1 = state[0], state[1]
    return mode == M_AFTER or (mode == M_NUM and aux1 in _NS_TERMINAL)


# --- token table + constraint ------------------------------------------------

class TokenTable:
    """Per-tokenizer token byte table + shared mask cache.

    Tokens with empty byte content (control/unknown pieces) are never
    grammar-legal; EOG ids are OR-ed in by ``mask_for`` when the state
    accepts end-of-output.
    """

    def __init__(self, pieces: Sequence[bytes], eog_ids: Iterable[int]):
        self.pieces: List[bytes] = [bytes(p) for p in pieces]
        self.n_vocab = len(self.pieces)
        self.n_words = (self.n_vocab + 31) // 32
        self.eog_ids = [i for i in eog_ids if 0 <= i < self.n_vocab]
        self.max_len = max((len(p) for p in self.pieces), default=1)
        self._eog_packed = np.zeros(self.n_words, np.uint32)
        for i in self.eog_ids:
            self._eog_packed[i >> 5] |= np.uint32(1 << (i & 31))
        # LRU-bounded: abstract states are minted per nesting pattern, so
        # an adversarial '[{[{[…' stream would otherwise grow this (and
        # pay a fresh vocab-wide fill) without limit
        self._cache: OrderedDict = OrderedDict()
        self._cache_cap = 4096
        self._cache_lock = threading.Lock()
        # prime on the constructing (HTTP) thread: the initial-state mask,
        # so that the scheduler loop never stalls on it
        self.mask_for(INITIAL_STATE)

    _build_lock = threading.Lock()

    @classmethod
    def for_tokenizer(cls, tok) -> "TokenTable":
        """Build (and cache on the tokenizer) the table for a Tokenizer.
        Locked: concurrent cold format:"json" requests must not each pay
        the table build and the initial mask fill."""
        with cls._build_lock:
            tbl = getattr(tok, "_constrain_table", None)
            if tbl is None:
                tbl = cls([tok.piece_bytes(i) for i in range(tok.n_vocab)],
                          tok.eog_ids)
                tok._constrain_table = tbl
        return tbl

    def _cache_key(self, state: bytes) -> bytes:
        """Abstract state: header + the stack suffix a single token could
        touch. A token of L bytes pops at most L containers, so a suffix of
        ``max_len`` container bytes (plus emptiness, which the suffix
        preserves) fully determines every token's acceptance."""
        return state[:4] + state[4:][-self.max_len:]

    def mask_for(self, state: bytes) -> np.ndarray:
        """Packed allowed-token mask [n_words] uint32 for ``state``."""
        key = self._cache_key(state)
        with self._cache_lock:
            m = self._cache.get(key)
            if m is not None:
                self._cache.move_to_end(key)
                return m
        mask = np.zeros(self.n_words, np.uint32)
        for tid, piece in enumerate(self.pieces):
            if piece and advance_bytes(state, piece) is not None:
                mask[tid >> 5] |= np.uint32(1 << (tid & 31))
        if eos_ok(state):
            if state[0] == M_AFTER:
                # value definitely closed: only whitespace could follow —
                # force EOS so the model stops instead of trailing forever
                mask = self._eog_packed.copy()
            else:
                # e.g. a top-level number: legal to extend OR to stop
                mask = mask | self._eog_packed
        with self._cache_lock:
            self._cache[key] = mask
            self._cache.move_to_end(key)
            while len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        return mask


class GrammarTable:
    """Device-side grammar tables: BFS over the PDA's reachable packed
    states (up to ``cap``) → a dense mask table + token transition table
    the decode program can index with a per-slot int32 state.

    ``mask [G, n_words] uint32`` — row g is ``mask_for`` of state g;
    ``trans [G, V] int32`` — next state id, or -1 when sampling that
    token leaves the table (state beyond ``cap``, an EOG token, or a
    grammar-illegal token the mask already excludes). The engine treats
    -1 as an ESCAPE: the slot freezes for the rest of the dispatch and
    the scheduler falls back to host-uploaded masks for it
    (runtime/scheduler.py ``_grammar_ack``). EOG escapes are harmless —
    the request finishes on that token anyway.

    State 0 is the BFS root (``start``). The tables are built once per
    (TokenTable, start, cap) and cached on the TokenTable; the build
    simulates only mask-allowed tokens, so it costs G mask fills (each a
    vocabulary sweep in Python) plus the allowed-token byte walks. JSON
    decode typically closes over a handful of abstract states, so a
    small ``cap`` (default 64 via TPU_GRAMMAR_STATES) covers common
    nesting depths and everything deeper degrades to the host path, never
    to wrong output."""

    def __init__(self, table: TokenTable, start: bytes = INITIAL_STATE,
                 cap: int = 64):
        self.table = table
        self.cap = cap
        V, n_words = table.n_vocab, table.n_words
        states: List[bytes] = [start]
        ids = {start: 0}
        mask_rows: List[np.ndarray] = []
        trans_rows: List[np.ndarray] = []
        eog = set(table.eog_ids)
        i = 0
        while i < len(states):
            st = states[i]
            i += 1
            mrow = table.mask_for(st)
            mask_rows.append(mrow)
            trow = np.full(V, -1, np.int32)
            allowed = np.nonzero(
                (mrow[:, None] >> np.arange(32, dtype=np.uint32)) & 1)
            for tid in (allowed[0] * 32 + allowed[1]):
                tid = int(tid)
                if tid >= V or tid in eog:
                    continue
                piece = table.pieces[tid]
                ns = advance_bytes(st, piece) if piece else None
                if ns is None:
                    continue
                nid = ids.get(ns)
                if nid is None:
                    if len(states) >= cap:
                        continue           # beyond cap → escape (-1)
                    nid = len(states)
                    ids[ns] = nid
                    states.append(ns)
                trow[tid] = nid
            trans_rows.append(trow)
        self.states = states
        self._ids = ids
        self.n_states = len(states)
        self.mask = np.stack(mask_rows)                    # [G, n_words]
        self.trans = np.stack(trans_rows)                  # [G, V]

    @classmethod
    def for_table(cls, table: TokenTable, start: bytes = INITIAL_STATE,
                  cap: int = 64) -> "GrammarTable":
        key = (bytes(start), int(cap))
        cache = getattr(table, "_grammar_tables", None)
        if cache is None:
            cache = table._grammar_tables = {}
        gt = cache.get(key)
        if gt is None:
            gt = cache[key] = cls(table, start, cap)
        return gt

    def state_id(self, state: Optional[bytes]) -> int:
        """Table id for an exact packed state, or -1 if it escaped.
        States from a different machine (e.g. a schema NFA tuple) never
        match — they stay on host masks."""
        if state is None:
            return -1
        try:
            return self._ids.get(bytes(state), -1)
        except (TypeError, ValueError):
            return -1


class JsonConstraint:
    """Per-request JSON grammar state for the engine/scheduler."""

    # packed-bytes PDA state: GrammarTable rows ARE this state space, so
    # the scheduler may run the constraint from device tables. Schema
    # constraints (NFA tuple states, per-schema masks) must stay on host
    # masks — their masks are strictly tighter than the JSON grammar's.
    grammar_table_ok = True

    def __init__(self, table: TokenTable):
        self.table = table
        self.state: Optional[bytes] = INITIAL_STATE

    @classmethod
    def for_tokenizer(cls, tok) -> "JsonConstraint":
        return cls(TokenTable.for_tokenizer(tok))

    def mask_row(self) -> np.ndarray:
        assert self.state is not None, "constraint already dead"
        return self.table.mask_for(self.state)

    def advance(self, tid: int) -> bool:
        """Feed one sampled token; False if it was grammar-illegal (which
        a masked sampler should never produce)."""
        if self.state is None:
            return False
        piece = (self.table.pieces[tid]
                 if 0 <= tid < self.table.n_vocab else b"")
        if not piece:
            return False
        nxt = advance_bytes(self.state, piece)
        self.state = nxt
        return nxt is not None

    @property
    def done(self) -> bool:
        return self.state is not None and eos_ok(self.state)
