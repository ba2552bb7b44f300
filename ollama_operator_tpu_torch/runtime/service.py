"""LoadedModel: one resident model = engine + scheduler + tokenizer +
prompt template + default options.

Counterpart of ``ollama_operator_tpu/runtime/service.py``: the text-level
API the HTTP layer calls (prompt templating, option merging, stop
sequences with holdback, streaming detokenisation). Everything below it
is token-level.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

from ..device import resolve_device
from ..models.config import ModelConfig
from ..server.template import DEFAULT_TEMPLATE, Template
from ..tokenizer import StreamDecoder, Tokenizer
from .engine import (Engine, EngineConfig, SlotOptions, resolve_cache_dtype,
                     resolve_kv_dtype_default, resolve_serving_defaults)
from .scheduler import Scheduler


class BadRequest(ValueError):
    """A request the client got wrong (HTTP 400)."""


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
        if int(o.get("mirostat", 0)) in (1, 2):
            raise BadRequest("mirostat sampling is not ported yet")
        so = SlotOptions(
            temperature=float(o.get("temperature", 0.8)),
            top_k=int(o.get("top_k", 40)),
            top_p=float(o.get("top_p", 0.9)),
            min_p=float(o.get("min_p", 0.0)),
            typical_p=float(o.get("typical_p", 1.0)),
            repeat_penalty=float(o.get("repeat_penalty", 1.1)),
            presence_penalty=float(o.get("presence_penalty", 0.0)),
            frequency_penalty=float(o.get("frequency_penalty", 0.0)),
            seed=int(o.get("seed", -1)),
            repeat_last_n=int(o.get("repeat_last_n", 64)))
        num_predict = int(o.get("num_predict", 128))
    except (TypeError, ValueError) as e:
        if isinstance(e, BadRequest):
            raise
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
    replaces the one in ``ecfg``."""

    def __init__(self, name: str, cfg: ModelConfig, params,
                 tokenizer: Tokenizer, template: Optional[str] = None,
                 system: Optional[str] = None,
                 default_params: Optional[Dict] = None,
                 ecfg: Optional[EngineConfig] = None, device="cuda",
                 kv_dtype: Optional[str] = None,
                 paged: Optional[bool] = None):
        self.device = resolve_device(device)
        self.name = name
        self.cfg = cfg
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

    def generate_stream(self, prompt_text: str,
                        options: Optional[Dict] = None,
                        context: Optional[List[int]] = None,
                        images: Optional[List] = None,
                        format: Optional[object] = None
                        ) -> Iterator[Tuple[str, Optional[GenerateResult]]]:
        """Yields (text_piece, None)… then ("", final GenerateResult).

        ``images`` (the request's list): every model of the port is
        text-only, so any image is refused, as the reference refuses one
        for a model without a vision projector. ``format``: None or ""
        asks for free text; "json" or a JSON-schema dict asks for
        constrained decoding, which is not ported yet and is refused;
        any other value is refused as the reference refuses it.

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
        if images:
            raise BadRequest(
                f"model {self.name} has no vision projector; it cannot "
                f"accept images")
        max_new = min(num_predict, self.engine.max_seq - len(ids) - 1)
        if max_new < 1:
            raise BadRequest(
                f"prompt of {len(ids)} tokens leaves no room to generate "
                f"within the {self.engine.max_seq}-token context")
        if format is not None and format != "":
            if format == "json" or isinstance(format, dict):
                raise BadRequest(
                    f"format {format!r} asks for constrained decoding, "
                    f"which is not ported yet")
            raise BadRequest(
                f"unsupported format {format!r}; expected \"json\" or "
                f"a JSON schema object")
        req = self.scheduler.submit(ids, so, max_new,
                                    eog_ids=frozenset(self.tokenizer.eog_ids))
        return self._stream(req, stops, ids, max_new, t0)

    def _stream(self, req, stops, ids, max_new, t0):
        sd = StreamDecoder(self.tokenizer)
        sm = StopMatcher(stops)
        result = GenerateResult(prompt_tokens=req.stats.n_prompt)
        all_ids: List[int] = []
        finished = False
        try:
            for chunk in req.chunks():
                all_ids.extend(chunk)
                piece = sm.feed(sd.feed_many(chunk))
                if piece:
                    result.text += piece
                    yield piece, None
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
            yield tail, None
        st = req.stats
        result.generated_tokens = st.n_generated
        result.ttft_s = st.ttft_s
        result.reused_tokens = st.n_reused
        result.total_s = time.monotonic() - t0
        result.done_reason = ("stop" if sm.hit or st.n_generated < max_new
                              else "length")
        result.context = ids + all_ids
        yield "", result

    def generate(self, prompt_text: str, options: Optional[Dict] = None
                 ) -> GenerateResult:
        final = None
        for _piece, res in self.generate_stream(prompt_text, options):
            if res is not None:
                final = res
        return final

    def unload(self):
        self.scheduler.shutdown()

    def unload_when_idle(self, poll_s: float = 0.05):
        """Unload once the scheduler has no request left (at once when it
        has none), so that a stop does not cut other clients' streams
        short."""
        while self.scheduler.has_pending and self.scheduler.broken is None:
            time.sleep(poll_s)
        self.unload()
