"""Tokenizers built purely from GGUF metadata (no sentencepiece/tiktoken).

A copy of ``ollama_operator_tpu/tokenizer/tokenizer.py``: the torch port
keeps its own copy and imports nothing of the JAX package.

The reference's tokenization happens inside the delegated llama.cpp runtime
(SURVEY.md §2.2); here it is re-implemented natively:

- ``model == "llama"`` → SentencePiece-style BPE: pieces + scores, greedy
  highest-score bigram merging, ``▁`` whitespace convention, ``<0xXX>`` byte
  fallback.
- ``model == "gpt2"`` → byte-level BPE: byte→unicode table + ranked merges
  (llama3, phi-2, qwen2, gemma-style vocabularies).

Both support streaming-safe incremental decoding (StreamDecoder) — bytes are
only emitted once they form complete UTF-8, which the server relies on for
chunked responses.
"""

from __future__ import annotations

import heapq
import re
from typing import Dict, Iterable, List, Optional, Sequence

# llama.cpp token-type enum
TT_UNDEFINED, TT_NORMAL, TT_UNKNOWN, TT_CONTROL, TT_USER_DEFINED, \
    TT_UNUSED, TT_BYTE = range(7)

_SPM_SPACE = "▁"  # ▁


def _bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's invertible byte→printable-unicode mapping."""
    bs = (list(range(ord("!"), ord("~") + 1)) +
          list(range(0xA1, 0xAD)) + list(range(0xAE, 0x100)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


_BYTE_ENC = _bytes_to_unicode()
_BYTE_DEC = {v: k for k, v in _BYTE_ENC.items()}

# GPT-2 pre-tokenizer, approximated for stdlib `re` (no \p classes):
# [^\W\d_] ≈ \p{L}; \d ≈ \p{N}; punctuation bucket catches the rest incl. _
_GPT2_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?(?:[^\s\w]|_)+"
    r"|\s+(?!\S)|\s+", re.UNICODE)


class Tokenizer:
    def __init__(self, model: str, tokens: Sequence[str],
                 scores: Optional[Sequence[float]] = None,
                 token_types: Optional[Sequence[int]] = None,
                 merges: Optional[Sequence[str]] = None,
                 bos_id: int = -1, eos_id: int = -1,
                 add_bos: bool = True, add_eos: bool = False,
                 add_space_prefix: bool = True,
                 extra_eog: Iterable[int] = ()):
        self.model = model
        self.tokens = list(tokens)
        self.scores = list(scores) if scores is not None else [0.0] * len(tokens)
        self.token_types = (list(token_types) if token_types is not None
                            else [TT_NORMAL] * len(tokens))
        self.vocab = {t: i for i, t in enumerate(self.tokens)}
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.add_bos = add_bos
        self.add_eos = add_eos
        self.add_space_prefix = add_space_prefix
        self.eog_ids = {eos_id} | set(extra_eog)
        self.eog_ids.discard(-1)
        # control/user-defined pieces must match before normal text
        self._specials = sorted(
            (t for i, t in enumerate(self.tokens)
             if self.token_types[i] in (TT_CONTROL, TT_USER_DEFINED)
             and t),
            key=len, reverse=True)
        self._special_re = (re.compile(
            "|".join(re.escape(s) for s in self._specials))
            if self._specials else None)
        if model == "gpt2":
            merges = merges or []
            self._ranks = {tuple(m.split(" ", 1)): r
                           for r, m in enumerate(merges)}
        if model == "bert":
            # WordPiece (embedding models: all-minilm & friends). Uncased
            # checkpoints ship all-lowercase vocabs — detect once so
            # encode() lowercases to match (llama.cpp reads the same
            # signal from the vocab rather than a metadata flag)
            self._wp_lower = not any(
                any(ch.isalpha() and ch.isupper() for ch in t)
                for t in self.tokens
                if not (t.startswith("[") and t.endswith("]")))
            self._unk_id = next(
                (i for i, t in enumerate(self.tokens) if t == "[UNK]"), 0)
        self._byte_ids = {}
        for i, t in enumerate(self.tokens):
            if self.token_types[i] == TT_BYTE and len(t) == 6:  # <0xXX>
                try:
                    self._byte_ids[int(t[3:5], 16)] = i
                except ValueError:
                    pass

    # -----------------------------------------------------------------
    @classmethod
    def from_gguf_metadata(cls, md: dict) -> "Tokenizer":
        model = md.get("tokenizer.ggml.model", "llama")
        tokens = md["tokenizer.ggml.tokens"]
        bos = md.get("tokenizer.ggml.bos_token_id", -1)
        eos = md.get("tokenizer.ggml.eos_token_id", -1)
        if model == "bert":
            # BERT frames sequences as [CLS] … [SEP]; conversions carry
            # cls/seperator ids (llama.cpp's spelling) instead of bos/eos
            bos = md.get("tokenizer.ggml.cls_token_id", bos)
            eos = md.get("tokenizer.ggml.seperator_token_id",
                         md.get("tokenizer.ggml.separator_token_id", eos))
            return cls(model=model, tokens=tokens,
                       token_types=md.get("tokenizer.ggml.token_type"),
                       bos_id=bos, eos_id=eos,
                       add_bos=md.get("tokenizer.ggml.add_bos_token", True),
                       add_eos=md.get("tokenizer.ggml.add_eos_token", True))
        extra = set()
        for key in ("tokenizer.ggml.eot_token_id",
                    "tokenizer.ggml.eom_token_id"):
            if key in md:
                extra.add(md[key])
        return cls(
            model=model,
            tokens=tokens,
            scores=md.get("tokenizer.ggml.scores"),
            token_types=md.get("tokenizer.ggml.token_type"),
            merges=md.get("tokenizer.ggml.merges"),
            bos_id=bos, eos_id=eos,
            add_bos=md.get("tokenizer.ggml.add_bos_token", model == "llama"),
            add_eos=md.get("tokenizer.ggml.add_eos_token", False),
            add_space_prefix=md.get("tokenizer.ggml.add_space_prefix", True),
            extra_eog=extra)

    @property
    def n_vocab(self) -> int:
        return len(self.tokens)

    def is_eog(self, tid: int) -> bool:
        return tid in self.eog_ids

    # -----------------------------------------------------------------
    # encoding
    # -----------------------------------------------------------------
    def encode(self, text: str, add_bos: Optional[bool] = None,
               parse_special: bool = True) -> List[int]:
        ids: List[int] = []
        if add_bos is None:
            add_bos = self.add_bos
        if add_bos and self.bos_id >= 0:
            ids.append(self.bos_id)
        # split out special tokens first, tokenize the text in between
        chunks: List = []
        if parse_special and self._special_re is not None:
            pos = 0
            for m in self._special_re.finditer(text):
                if m.start() > pos:
                    chunks.append(text[pos:m.start()])
                chunks.append(self.vocab[m.group()])
                pos = m.end()
            if pos < len(text):
                chunks.append(text[pos:])
        else:
            chunks.append(text)
        first_text = True
        for c in chunks:
            if isinstance(c, int):
                ids.append(c)
                continue
            if self.model == "gpt2":
                ids.extend(self._encode_bpe(c))
            elif self.model == "bert":
                ids.extend(self._encode_wpm(c))
            else:
                ids.extend(self._encode_spm(c, first_text))
            first_text = False
        if self.add_eos and self.eos_id >= 0:
            ids.append(self.eos_id)
        return ids

    # -- WordPiece (bert embedding models) -----------------------------
    def _encode_wpm(self, text: str) -> List[int]:
        """BERT WordPiece: basic-clean + (uncased) lowercase/strip-accents
        normalization, whitespace + punctuation pre-split, then greedy
        longest-prefix matching with ##-continuations; a word with no
        full cover collapses to [UNK] (canonical WordPiece semantics)."""
        import unicodedata
        if getattr(self, "_wp_lower", False):
            text = text.lower()
            text = "".join(ch for ch in unicodedata.normalize("NFD", text)
                           if unicodedata.category(ch) != "Mn")

        def is_punct(ch):
            return (unicodedata.category(ch).startswith("P")
                    or (33 <= ord(ch) <= 47) or (58 <= ord(ch) <= 64)
                    or (91 <= ord(ch) <= 96) or (123 <= ord(ch) <= 126))

        words: List[str] = []
        buf = []
        for ch in text:
            if ch.isspace():
                if buf:
                    words.append("".join(buf))
                    buf = []
            elif is_punct(ch) or 0x4E00 <= ord(ch) <= 0x9FFF:
                # punctuation and CJK split to single-char words
                if buf:
                    words.append("".join(buf))
                    buf = []
                words.append(ch)
            else:
                buf.append(ch)
        if buf:
            words.append("".join(buf))

        ids: List[int] = []
        for word in words:
            if len(word) > 100:
                ids.append(self._unk_id)
                continue
            out, start, ok = [], 0, True
            while start < len(word):
                end = len(word)
                piece_id = None
                while end > start:
                    sub = word[start:end]
                    if start > 0:
                        sub = "##" + sub
                    if sub in self.vocab:
                        piece_id = self.vocab[sub]
                        break
                    end -= 1
                if piece_id is None:
                    ok = False
                    break
                out.append(piece_id)
                start = end
            ids.extend(out if ok else [self._unk_id])
        return ids

    # -- SPM (llama) ---------------------------------------------------
    def _encode_spm(self, text: str, is_first: bool) -> List[int]:
        if not text:
            return []
        if self.add_space_prefix and is_first:
            text = " " + text
        text = text.replace(" ", _SPM_SPACE)
        symbols: List[str] = list(text)

        # greedy highest-score bigram merge (scores are log-probs)
        nxt = list(range(1, len(symbols) + 1))
        prv = list(range(-1, len(symbols) - 1))
        alive = [True] * len(symbols)

        def try_pair(i):
            j = nxt[i]
            if j >= len(symbols):
                return None
            merged = symbols[i] + symbols[j]
            tid = self.vocab.get(merged)
            if tid is None:
                return None
            return (-self.scores[tid], i, merged)

        heap = []
        for i in range(len(symbols) - 1):
            p = try_pair(i)
            if p:
                heapq.heappush(heap, p)
        while heap:
            negs, i, merged = heapq.heappop(heap)
            j = nxt[i] if i < len(nxt) else None
            if (not alive[i] or j is None or j >= len(symbols)
                    or not alive[j] or symbols[i] + symbols[j] != merged):
                continue
            symbols[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < len(symbols):
                prv[nxt[i]] = i
            for cand in (try_pair(prv[i]) if prv[i] >= 0 and alive[prv[i]]
                         else None, try_pair(i)):
                if cand:
                    heapq.heappush(heap, cand)

        out: List[int] = []
        for i, s in enumerate(symbols):
            if not alive[i]:
                continue
            tid = self.vocab.get(s)
            if tid is not None:
                out.append(tid)
            else:  # byte fallback
                for b in s.encode("utf-8"):
                    if b in self._byte_ids:
                        out.append(self._byte_ids[b])
                    elif self.vocab.get("<unk>") is not None:
                        out.append(self.vocab["<unk>"])
        return out

    # -- byte-level BPE (gpt2) -----------------------------------------
    def _bpe_merge(self, word: List[str]) -> List[str]:
        while len(word) > 1:
            best, best_rank = None, None
            for k in range(len(word) - 1):
                r = self._ranks.get((word[k], word[k + 1]))
                if r is not None and (best_rank is None or r < best_rank):
                    best, best_rank = k, r
            if best is None:
                break
            word[best:best + 2] = [word[best] + word[best + 1]]
        return word

    def _encode_bpe(self, text: str) -> List[int]:
        out: List[int] = []
        for m in _GPT2_PAT.finditer(text):
            chunk = m.group()
            mapped = "".join(_BYTE_ENC[b] for b in chunk.encode("utf-8"))
            for piece in self._bpe_merge(list(mapped)):
                tid = self.vocab.get(piece)
                if tid is not None:
                    out.append(tid)
                else:
                    for ch in piece:
                        tid = self.vocab.get(ch)
                        if tid is not None:
                            out.append(tid)
        return out

    # -----------------------------------------------------------------
    # decoding
    # -----------------------------------------------------------------
    def piece_bytes(self, tid: int) -> bytes:
        """Raw bytes of one token (may be partial UTF-8)."""
        if tid < 0 or tid >= len(self.tokens):
            return b""
        t = self.tokens[tid]
        tt = self.token_types[tid]
        if tt == TT_BYTE:
            try:
                return bytes([int(t[3:5], 16)])
            except (ValueError, IndexError):
                return b""
        if tt in (TT_CONTROL, TT_UNKNOWN, TT_UNUSED):
            return b""
        if self.model == "gpt2":
            return bytes(_BYTE_DEC.get(c, ord(" ") & 0xFF) for c in t)
        return t.replace(_SPM_SPACE, " ").encode("utf-8")

    def decode(self, ids: Sequence[int]) -> str:
        return b"".join(self.piece_bytes(i) for i in ids).decode(
            "utf-8", errors="replace")


class StreamDecoder:
    """Incremental detokeniser that never emits partial UTF-8 sequences."""

    def __init__(self, tok: Tokenizer):
        self.tok = tok
        self._buf = b""

    def feed(self, tid: int) -> str:
        self._buf += self.tok.piece_bytes(tid)
        # emit the longest prefix that is valid UTF-8
        for cut in range(len(self._buf), max(len(self._buf) - 4, -1), -1):
            try:
                s = self._buf[:cut].decode("utf-8")
                self._buf = self._buf[cut:]
                return s
            except UnicodeDecodeError:
                continue
        return ""

    def feed_many(self, tids) -> str:
        """Batch form of feed(): join a whole decode chunk's piece bytes
        and run ONE valid-prefix scan over the result, instead of one
        buffer append + scan per token."""
        self._buf += b"".join(self.tok.piece_bytes(t) for t in tids)
        for cut in range(len(self._buf), max(len(self._buf) - 4, -1), -1):
            try:
                s = self._buf[:cut].decode("utf-8")
                self._buf = self._buf[cut:]
                return s
            except UnicodeDecodeError:
                continue
        return ""

    def flush(self) -> str:
        s = self._buf.decode("utf-8", errors="replace")
        self._buf = b""
        return s
