"""LoadedModel: one resident model = engine + scheduler + tokenizer +
prompt template + default options; EmbeddingModel: one resident encoder.

Counterpart of ``ollama_operator_tpu/runtime/service.py``: the text-level
API the HTTP layer calls (prompt and chat templating, option merging, stop
sequences with holdback, streaming detokenisation, the grammar constraint
of ``format``, the request budgets: ``deadline_ms``, ``priority``,
``tenant`` and ``ttft_slo_ms``, resolved as the reference resolves them,
images through a llava model's vision tower and projector, spliced into
the prompt's embeddings, and embeddings: mean-pooled final hidden states
of a decoder, or a BERT encoder's pooled output). Everything below it is
token-level.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
import threading
import time
from collections import OrderedDict
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..models import decoder as D
from ..models import encoder as E
from ..models import vision as V
from ..models.config import ModelConfig
from ..ops.constrain import JsonConstraint
from ..ops.schema import SchemaConstraint, compile_schema
from ..server.metrics import GLOBAL as METRICS
from ..server.images import decode_image, preprocess
from ..server.template import DEFAULT_TEMPLATE, Template
from ..server.tools import to_template_tool_calls, to_template_tools
from ..tokenizer import StreamDecoder, Tokenizer
from .admission import resolve_priority, resolve_tenant, resolve_ttft_slo_s
from .engine import (Engine, EngineConfig, SlotOptions, resolve_cache_dtype,
                     resolve_kv_dtype_default, resolve_serving_defaults)
from .errors import BadRequest
from .scheduler import Scheduler

__all__ = ["BadRequest", "EmbeddingModel", "GenerateResult", "LoadedModel",
           "merge_options", "resolve_deadline_s"]


def resolve_deadline_s(defaults: Optional[Dict],
                       options: Optional[Dict]) -> Optional[float]:
    """Per-request wall-clock budget in seconds, or None for unlimited.

    Precedence: request ``deadline_ms`` option > modelfile default >
    ``TPU_REQUEST_DEADLINE_MS`` env. 0 (or absent everywhere) disables.
    """
    o = dict(defaults or {})
    o.update(options or {})
    raw = o.get("deadline_ms")
    if raw is None:
        raw = os.environ.get("TPU_REQUEST_DEADLINE_MS") or None
    if raw is None:
        return None
    try:
        ms = float(raw)
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid deadline_ms: {raw!r}") from e
    if ms < 0:
        raise BadRequest("deadline_ms must be >= 0")
    return ms / 1000.0 if ms > 0 else None


@dataclasses.dataclass
class GenerateResult:
    text: str = ""
    prompt_tokens: int = 0
    generated_tokens: int = 0
    ttft_s: float = 0.0
    total_s: float = 0.0
    done_reason: str = "stop"
    context: List[int] = dataclasses.field(default_factory=list)
    # prompt tokens whose K/V came from a cached prefix (no prefill)
    reused_tokens: int = 0
    # scheduler request id: the handle for GET /debug/trace?id=
    request_id: int = 0
    # per-stage span summary (runtime/trace.py), only when the request
    # asked for it (options.trace true): the final frame's "timings"
    timings: Optional[Dict] = None


class _OwnedStream:
    """An iterator that owns its scheduler request: submission is eager,
    so a stream dropped before its first next() (the client went away
    while the headers were written) must still cancel the request."""

    def __init__(self, it, req):
        self._it, self._req = it, req
        self._started = False
        # the span timeline, for the HTTP layer's flush events
        self.trace = req.trace

    def __iter__(self):
        return self

    def __next__(self):
        self._started = True
        return next(self._it)

    def close(self):
        if not self._started:
            self._req.cancel()
        self._it.close()

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — never raise from GC
            pass


class _Piece(str):
    """A detokenised text piece that remembers how many scheduler tokens
    produced it. The stream stays (str, final) pairs, but the HTTP frame
    coalescer counts tokens a piece, not characters."""

    n_tokens = 1

    @staticmethod
    def of(text: str, n: int) -> "_Piece":
        p = _Piece(text)
        p.n_tokens = n
        return p


# a once-a-process notice that a schema fell back to generic JSON
_schema_warned = [False]


def merge_options(defaults: Dict, request: Optional[Dict]
                  ) -> Tuple[SlotOptions, int, List[str]]:
    """(modelfile params, request options) → (SlotOptions, num_predict,
    stop strings)."""
    o = dict(defaults or {})
    o.update(request or {})
    stop = o.get("stop") or []
    if isinstance(stop, str):
        stop = [stop]
    try:
        mirostat = int(o.get("mirostat", 0))
        so = SlotOptions(
            temperature=float(o.get("temperature", 0.8)),
            top_k=int(o.get("top_k", 40)),
            top_p=float(o.get("top_p", 0.9)),
            min_p=float(o.get("min_p", 0.0)),
            typical_p=float(o.get("typical_p", 1.0)),
            repeat_penalty=float(o.get("repeat_penalty", 1.1)),
            presence_penalty=float(o.get("presence_penalty", 0.0)),
            frequency_penalty=float(o.get("frequency_penalty", 0.0)),
            # llama.cpp treats any value other than 1/2 as off
            mirostat=mirostat if mirostat in (1, 2) else 0,
            mirostat_tau=float(o.get("mirostat_tau", 5.0)),
            mirostat_eta=float(o.get("mirostat_eta", 0.1)),
            seed=int(o.get("seed", -1)),
            repeat_last_n=int(o.get("repeat_last_n", 64)))
        num_predict = int(o.get("num_predict", 128))
    except (TypeError, ValueError) as e:
        raise BadRequest(f"invalid options: {e}") from e
    if num_predict < 0:
        num_predict = 1 << 30  # -1 = unlimited (bounded by context)
    return so, num_predict, list(stop)


class StopMatcher:
    """Streaming stop-sequence matcher with holdback of partial matches."""

    def __init__(self, stops: Sequence[str]):
        self.stops = [s for s in stops if s]
        self.buf = ""
        self.hit = False

    def feed(self, piece: str) -> str:
        if self.hit:
            return ""
        if not self.stops:
            return piece
        self.buf += piece
        cut = None
        for s in self.stops:
            idx = self.buf.find(s)
            if idx >= 0 and (cut is None or idx < cut):
                cut = idx
        if cut is not None:
            out, self.buf = self.buf[:cut], ""
            self.hit = True
            return out
        # hold back the longest tail that could begin a stop string
        hold = 0
        for s in self.stops:
            for k in range(min(len(s) - 1, len(self.buf)), 0, -1):
                if self.buf.endswith(s[:k]):
                    hold = max(hold, k)
                    break
        if hold:
            out, self.buf = self.buf[:-hold], self.buf[-hold:]
            return out
        out, self.buf = self.buf, ""
        return out

    def flush(self) -> str:
        out, self.buf = self.buf, ""
        return "" if self.hit else out


class LoadedModel:
    """A model resident on ``device`` (the card unless the caller asks
    for the CPU), serving text generation.

    With ``ecfg`` None the engine takes the serving defaults the JAX
    package's model manager resolves: ``max_seq_len`` =
    min(model context, ``num_ctx`` or 4096), the device's KV dtype (int8
    on the card) and :func:`resolve_serving_defaults` for the cache kind,
    slots, page size, pool size and decode chunk. ``kv_dtype`` names the
    KV cache's storage as the JAX server's ``--kv-dtype`` does ("int8",
    "int4", "bfloat16", "float32") and ``paged`` its kind as the JAX
    server's ``--paged`` does (True: the page pool; False: the dense slot
    cache; None: resolved per model and device); each, when given,
    replaces the one in ``ecfg``. ``vision`` (a llava model's projector
    layer): (``models.vision.VisionConfig``, its params on ``device``)."""

    def __init__(self, name: str, cfg: ModelConfig, params,
                 tokenizer: Tokenizer, template: Optional[str] = None,
                 system: Optional[str] = None,
                 default_params: Optional[Dict] = None,
                 ecfg: Optional[EngineConfig] = None, device="cuda",
                 kv_dtype: Optional[str] = None,
                 paged: Optional[bool] = None,
                 vision: Optional[Tuple] = None):
        self.device = resolve_device(device)
        self.name = name
        self.cfg = cfg
        self.vision = vision
        self.tokenizer = tokenizer
        self.template = Template(template or DEFAULT_TEMPLATE)
        self.system = system
        self.default_params = default_params or {}
        self.loaded_at = time.time()
        # the weight dtype the model manager resolved (None when built
        # directly from an already-converted tree)
        self.serving_dtype: Optional[str] = None
        # the blob digest of a model the manager loaded from its store
        # (None for one built in-process)
        self.digest: Optional[str] = None
        if ecfg is None:
            ecfg = resolve_serving_defaults(EngineConfig(
                max_slots=0, decode_chunk=0, page_size=0, paged=paged,
                max_seq_len=min(cfg.max_seq_len, int(
                    self.default_params.get("num_ctx", 4096))),
                cache_dtype=resolve_kv_dtype_default(self.device)),
                cfg, self.device)
        elif paged is not None:
            ecfg = dataclasses.replace(ecfg, paged=paged)
        if kv_dtype is not None:
            ecfg = dataclasses.replace(
                ecfg, cache_dtype=resolve_cache_dtype(kv_dtype))
        self.ecfg = ecfg
        self.engine = Engine(cfg, params, ecfg=ecfg, device=self.device)
        self.scheduler = Scheduler(self.engine)
        # embeddings run on the caller's thread, one at a time
        self._embed_lock = threading.Lock()
        # compiled JSON schemas of recent ``format`` requests (None for a
        # schema outside the supported subset), least recently used first
        self._schemas: "OrderedDict[str, object]" = OrderedDict()

    def _make_constraint(self, format):
        """format "json" → the generic JSON grammar; a schema dict → the
        compiled skeleton machine (ops/schema.py) when the schema is in
        the supported subset, else generic JSON with a once-a-process
        warning (never a silently wrong constraint)."""
        if isinstance(format, dict):
            key = json.dumps(format, sort_keys=True)
            if key in self._schemas:
                sch = self._schemas[key]
                self._schemas.move_to_end(key)
            else:
                sch = compile_schema(format)
                if len(self._schemas) > 64:
                    # evict one stale entry: a wholesale clear would pay
                    # again every machine's per-state mask cache
                    self._schemas.popitem(last=False)
                self._schemas[key] = sch   # None cached too (unsupported)
            if sch is not None:
                c = SchemaConstraint.for_tokenizer(sch, self.tokenizer)
                # the initial mask on the HTTP thread (later novel states
                # fill on the scheduler thread)
                c.mask_row()
                return c
            if not _schema_warned[0]:
                _schema_warned[0] = True
                print("warning: JSON schema outside the supported subset; "
                      "constraining to generic JSON only",
                      file=sys.stderr, flush=True)
        return JsonConstraint.for_tokenizer(self.tokenizer)

    def encode_images(self, images_u8) -> torch.Tensor:
        """uint8 [H, W, 3] arrays → [n_img, n_patches, D] f32 image
        tokens (the tower and projector on the model's device)."""
        vcfg, vparams = self.vision
        batch = np.stack([preprocess(im, vcfg.image_size)
                          for im in images_u8])
        with torch.inference_mode():
            return V.encode(vcfg, vparams,
                            torch.from_numpy(batch).to(self.device))

    def splice_images(self, ids: List[int], images_u8
                      ) -> Tuple[List[int], torch.Tensor]:
        """Text ids + decoded images → (padded ids, embeds [n, D] f32).

        The image tokens go after the BOS token (llava: the image context
        precedes the instruction), whatever the template; the padded ids
        carry the pad id ``vocab_size`` at image positions (only the
        penalty counts see it)."""
        img = self.encode_images(images_u8)               # [n_img, N, D]
        n_img, N, Dm = img.shape
        with torch.inference_mode():
            text = D._embed(self.cfg, self.engine.params, torch.tensor(
                ids, dtype=torch.long, device=self.device)).float()
        cut = 1 if (ids and self.tokenizer.add_bos
                    and ids[0] == self.tokenizer.bos_id) else 0
        embeds = torch.cat([text[:cut], img.reshape(n_img * N, Dm),
                            text[cut:]])
        pad = [self.cfg.vocab_size] * (n_img * N)
        return list(ids[:cut]) + pad + list(ids[cut:]), embeds

    def render_prompt(self, prompt: str, system: Optional[str] = None,
                      template: Optional[str] = None,
                      suffix: Optional[str] = None) -> str:
        """``suffix`` enables fill-in-middle (code models): it renders
        through the template's ``.Suffix``; a template without a suffix
        section cannot insert, which is a client error (the reference
        answers the same way)."""
        tpl = Template(template) if template else self.template
        system = system if system is not None else (self.system or "")
        if suffix:
            if ".Suffix" not in tpl.src:
                raise BadRequest(
                    f"model {self.name} does not support insert (its "
                    f"template has no .Suffix section)")
            return tpl.render(prompt=prompt, suffix=suffix, system=system)
        return tpl.render(prompt=prompt, system=system)

    def render_chat(self, messages: List[Dict],
                    template: Optional[str] = None,
                    tools: Optional[List[Dict]] = None) -> str:
        """Render a messages list. Templates that iterate ``.Messages``
        get them (the system messages merged into one, after the model's
        own system prompt); others get the flattened view (system and the
        last message as the prompt). ``tools`` (OpenAI wire shape) render
        through the template's ``.Tools``; a template without a tools
        section cannot honour them, which is a client error."""
        tpl = Template(template) if template else self.template
        if tools and ".Tools" not in tpl.src:
            raise BadRequest(
                f"model {self.name} does not support tools (its template "
                f"has no .Tools section)")
        system = self.system or ""
        sys_parts = [m["content"] for m in messages
                     if m.get("role") == "system"]
        if sys_parts:
            system = "\n".join(([system] if system else []) + sys_parts)
        msgs = []
        for m in messages:
            if m.get("role") == "system":
                continue
            entry = {"Role": m.get("role", "user"),
                     "Content": m.get("content", "") or ""}
            if m.get("tool_calls"):
                entry["ToolCalls"] = to_template_tool_calls(m["tool_calls"])
            msgs.append(entry)
        tpl_tools = to_template_tools(tools) if tools else []
        if ".Messages" in tpl.src:
            if system:
                msgs = [{"Role": "system", "Content": system}] + msgs
            return tpl.render(messages=msgs, system=system, prompt="",
                              tools=tpl_tools)
        prompt = msgs[-1]["Content"] if msgs else ""
        return tpl.render(system=system, prompt=prompt, tools=tpl_tools)

    def generate_stream(self, prompt_text: str,
                        options: Optional[Dict] = None,
                        context: Optional[List[int]] = None,
                        images: Optional[List] = None,
                        format: Optional[object] = None
                        ) -> Iterator[Tuple[str, Optional[GenerateResult]]]:
        """Yields (text_piece, None)… then ("", final GenerateResult).

        ``images`` (the request's list: base64 strings, raw bytes, or
        uint8 [H, W, 3] arrays): on a model without a vision projector a
        400, as the reference answers; else each is decoded (an
        undecodable one is a 400, "invalid image: ..."), run through the
        tower and projector and spliced after the BOS token
        (:meth:`splice_images`); ``prompt_eval_count`` counts the image
        tokens, and the returned context holds the real token ids only
        (a continuation re-prefills without the image). ``format``: None or ""
        asks for free text; "json" or a JSON-schema dict turns on
        grammar-constrained decoding (``ops/constrain.py``,
        ``ops/schema.py``): every token is legal for the grammar, and an
        output that ends with "stop" is a complete JSON value (of the
        schema, when it is in the supported subset); any other value is
        refused as the reference refuses it. Text pieces come as
        ``_Piece`` strings that carry their token counts.

        The budgets: ``deadline_ms`` (a request still waiting when it
        passes is shed with 503, one that streamed tokens ends with
        ``done_reason`` "timeout"), ``priority`` (high, normal,
        best_effort), ``tenant`` (its fair-queuing bucket) and
        ``ttft_slo_ms`` (refused at once when the queue model predicts a
        miss), each resolved as the reference resolves it (request >
        modelfile > environment) and refused with its 400 when bad.
        ``trace`` true puts the span summary in ``timings``.
        ``disagg_prefill`` true is refused: disaggregated prefill is not
        ported.

        Options, tokenization and submission run at call time, so bad
        requests and a full queue raise before the caller commits a
        streamed response."""
        so, num_predict, stops = merge_options(self.default_params, options)
        t0 = time.monotonic()
        ids = list(context or [])
        ids += self.tokenizer.encode(
            prompt_text, add_bos=(not ids) and self.tokenizer.add_bos)
        if not ids:
            raise BadRequest("the prompt encodes to no tokens")
        embeds = None
        context_ids = ids
        if images:
            if self.vision is None:
                raise BadRequest(
                    f"model {self.name} has no vision projector; it cannot "
                    f"accept images")
            ids, embeds = self.splice_images(ids, [
                im if isinstance(im, np.ndarray) else decode_image(im)
                for im in images])
        max_new = min(num_predict, self.engine.max_seq - len(ids) - 1)
        if max_new < 1:
            raise BadRequest(
                f"prompt of {len(ids)} tokens leaves no room to generate "
                f"within the {self.engine.max_seq}-token context")
        constraint = None
        if format is not None and format != "":
            if format == "json" or isinstance(format, dict):
                constraint = self._make_constraint(format)
            else:
                raise BadRequest(
                    f"unsupported format {format!r}; expected \"json\" or "
                    f"a JSON schema object")
        if (options or {}).get("disagg_prefill"):
            raise BadRequest("disagg_prefill: disaggregated prefill is not "
                             "ported to the torch server")
        req = self.scheduler.submit(ids, so, max_new,
                                    eog_ids=frozenset(self.tokenizer.eog_ids),
                                    embeds=embeds, constraint=constraint,
                                    deadline_s=resolve_deadline_s(
                                        self.default_params, options),
                                    priority=resolve_priority(
                                        self.default_params, options),
                                    tenant=resolve_tenant(options),
                                    ttft_slo_s=resolve_ttft_slo_s(
                                        self.default_params, options))
        want_timings = bool((options or {}).get("trace"))
        return _OwnedStream(self._stream(req, stops, context_ids, max_new,
                                         t0, want_timings), req)

    def _stream(self, req, stops, ids, max_new, t0, want_timings=False):
        sd = StreamDecoder(self.tokenizer)
        sm = StopMatcher(stops)
        result = GenerateResult(prompt_tokens=req.stats.n_prompt)
        all_ids: List[int] = []
        finished = False
        try:
            for chunk in req.chunks():
                all_ids.extend(chunk)
                req.trace.event("detok", n=len(chunk))
                piece = sm.feed(sd.feed_many(chunk))
                if piece:
                    result.text += piece
                    yield _Piece.of(piece, len(chunk)), None
                if sm.hit:
                    req.cancel()
                    break
            finished = True
        finally:
            # closed early (client gone): free the slot
            if not finished:
                req.cancel()
        tail = sm.feed(sd.flush()) + sm.flush()
        if tail:
            result.text += tail
            yield _Piece.of(tail, 0), None   # its tokens were counted
        st = req.stats
        result.generated_tokens = st.n_generated
        result.ttft_s = st.ttft_s
        result.reused_tokens = st.n_reused
        result.total_s = time.monotonic() - t0
        if req.done_reason in ("timeout", "drain"):
            # the deadline passed mid-generation, or the drain window
            # closed around a running stream: the partial output stands
            result.done_reason = req.done_reason
        else:
            result.done_reason = ("stop" if sm.hit or st.n_generated < max_new
                                  else "length")
        result.context = ids + all_ids
        METRICS.inc("tpu_model_requests_total")
        METRICS.inc("tpu_model_generated_tokens_total", st.n_generated)
        METRICS.inc("tpu_model_prompt_tokens_total", len(ids))
        if st.n_reused:
            METRICS.inc("tpu_model_prefix_reused_tokens_total", st.n_reused)
        METRICS.observe("tpu_model_ttft_seconds", st.ttft_s)
        if st.decode_tok_s > 0:
            METRICS.observe("tpu_model_decode_tokens_per_second",
                            st.decode_tok_s)
        result.request_id = req.id
        if want_timings:
            result.timings = req.trace.timings()
        yield "", result

    def generate(self, prompt_text: str, options: Optional[Dict] = None
                 ) -> GenerateResult:
        final = None
        for _piece, res in self.generate_stream(prompt_text, options):
            if res is not None:
                final = res
        return final

    def embed(self, texts: List[str]) -> np.ndarray:
        """Mean-pooled final hidden states (ollama /api/embeddings), as the
        JAX ``LoadedModel.embed``: each text tokenized, texts bucketed by
        length (T = max(16, the next power of two)), each bucket run as
        one [n_pad, T] batch (n_pad the next power of two of its texts) by
        :func:`decoder.embed_forward`, rows returned in input order as
        [N, D] float32. Runs on the caller's thread, on the stream the
        decode loop enqueues to, one call at a time."""
        with self._embed_lock:
            all_ids = [self.tokenizer.encode(t) for t in texts]
            buckets: Dict[int, List[int]] = {}
            for i, ids in enumerate(all_ids):
                T = max(16, 1 << (max(len(ids), 1) - 1).bit_length())
                buckets.setdefault(T, []).append(i)
            outs: List[Optional[np.ndarray]] = [None] * len(texts)
            dev = self.device
            for T, idxs in sorted(buckets.items()):
                n_pad = 1 << (len(idxs) - 1).bit_length()
                toks = np.zeros((n_pad, T), np.int64)
                lens = np.zeros((n_pad,), np.int64)
                for row, i in enumerate(idxs):
                    ids = all_ids[i]
                    toks[row, :len(ids)] = ids
                    lens[row] = len(ids)
                with torch.inference_mode():
                    out = D.embed_forward(
                        self.engine.params, self.cfg,
                        torch.from_numpy(toks).to(dev),
                        torch.from_numpy(lens).to(dev)).cpu().numpy()
                for row, i in enumerate(idxs):
                    outs[i] = out[row]
            return np.stack(outs)

    def begin_drain(self):
        self.scheduler.begin_drain()

    def drain(self, timeout_s: Optional[float] = None) -> int:
        """Graceful drain of this model's scheduler; returns the
        stragglers it ended (``Scheduler.drain``)."""
        return self.scheduler.drain(timeout_s)

    def unload(self):
        self.scheduler.shutdown()

    def unload_when_idle(self, poll_s: float = 0.05):
        """Unload once the scheduler has no request left (at once when it
        has none), so that a stop does not cut other clients' streams
        short."""
        while self.scheduler.has_pending and self.scheduler.broken is None:
            time.sleep(poll_s)
        self.unload()


class _IdleScheduler:
    """Scheduler facade for embedding-only models: always quiet, never
    broken. The model manager's reaper, probes, drain and ``/api/ps`` read
    these fields on every resident model; an encoder has no decode loop,
    so they stay "off"."""
    n_active = 0
    qsize = 0
    has_pending = False
    broken = None
    n_restarts = 0
    prefix_hit_tokens = 0
    prefix_miss_tokens = 0

    def admission_stats(self) -> dict:
        return {}   # no waiting line to police

    def lifecycle_stats(self) -> dict:
        return {}   # nothing to replay, drain or watch

    def utilization_stats(self, window_s: float = 60.0) -> dict:
        return {}   # no dispatches to account


class EmbeddingModel:
    """A resident encoder (BERT family) on ``device`` (the card unless the
    caller asks for the CPU): a tokenizer and one bidirectional forward
    (``models/encoder.py``), no Engine, KV cache or decode loop. It serves
    /api/embed, /api/embeddings and /v1/embeddings; the generation
    surface answers 400, as the JAX ``EmbeddingModel`` does. ``params``
    is a tree of f32 tensors on ``device``."""

    def __init__(self, name: str, cfg, params, tokenizer: Tokenizer,
                 digest: Optional[str] = None, device="cuda"):
        self.device = resolve_device(device)
        self.name = name
        self.cfg = cfg
        self.digest = digest
        self.tokenizer = tokenizer
        self.loaded_at = time.time()
        self.params = params
        self.scheduler = _IdleScheduler()
        self.serving_dtype = "float32"
        self.is_encoder = True
        self._lock = threading.Lock()

    def embed(self, texts: List[str]) -> np.ndarray:
        """[N, D] float32, unnormalized (``encoder.embed_batch``)."""
        ids = [self.tokenizer.encode(t) for t in texts]
        with self._lock:
            return E.embed_batch(self.params, self.cfg, ids)

    def _reject(self, *_a, **_kw):
        raise BadRequest(f"{self.name!r} is an embedding model (arch "
                         f"{self.cfg.arch}); it does not support "
                         f"generation — use /api/embed")

    generate = generate_stream = render_chat = render_prompt = _reject

    def begin_drain(self):
        pass        # no streams: the drain is instant

    def drain(self, timeout_s: Optional[float] = None) -> int:
        return 0

    def unload(self):
        self.params = None
