"""The serving engine: prefill and chunked decode over a paged KV pool.

Counterpart of ``ollama_operator_tpu/runtime/engine.py`` for its default
serving path on one device: slots share a physical page pool (int8 on the
card by default, int4 on request), admissions prefill one prompt in a
power-of-two bucket and insert its K/V into the slot's pages, and every
decode dispatch advances all slots ``decode_chunk`` steps. The surface the
scheduler drives is the JAX engine's: ``admit``, ``decode_n_launch`` →
``DecodeHandle.wait``, ``prepare_decode``, ``release``, ``can_admit``,
``admissible``, ``free_slots``, ``bucket_for``.

PyTorch runs eagerly, so there is nothing to compile: a decode dispatch is
the host loop that enqueues ``n`` steps on the device, and its handle
waits on a CUDA event recorded after the last step (on the CPU the work is
done by the time the launch returns). The dense slot cache, radix prefix
cache, extend, speculative decoding, grammars, mirostat and multi-device
meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import decoder
from ..models.config import ModelConfig
from ..ops import sampling
from .paged import PageTable, PagesExhausted


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine sizing. The port is paged-only, so the JAX config's
    ``paged`` flag has no counterpart; 0 in ``max_slots``,
    ``decode_chunk`` or ``page_size`` means "resolve per device"
    (:func:`resolve_serving_defaults`), as in the JAX package."""
    max_slots: int = 8
    max_seq_len: int = 2048
    # torch.bfloat16 / torch.float32 pools, torch.int8 for the quantized
    # pool (int8 codes + per-(position, head) f32 scales), or the string
    # "int4" for the nibble-packed pool (resolve_cache_dtype)
    cache_dtype: Union[torch.dtype, str] = torch.bfloat16
    min_prefill_bucket: int = 64
    # penalty window capacity (Ollama repeat_last_n default)
    repeat_last_n: int = 64
    decode_chunk: int = 8
    page_size: int = 64
    # data pages in the pool (excl. the trash page); None = the dense
    # equivalent max_slots * max_seq_len / page_size
    n_pages: Optional[int] = None


def resolve_serving_defaults(ecfg: EngineConfig, cfg: ModelConfig,
                             device) -> EngineConfig:
    """The JAX package's ``resolve_serving_defaults`` with the card in the
    place of the TPU: on CUDA a GQA model gets 64 slots, page size 128,
    decode chunk 32 and, with auto slots and no explicit pool size, a
    pool of the dense-24 byte ceiling (768 pages at max_seq_len 4096);
    elsewhere 32 slots, page size 64, chunk 8 and a dense-8 pool."""
    on_card = torch.device(device).type == "cuda"
    gqa = cfg.n_kv_heads < cfg.n_heads
    chunk = ecfg.decode_chunk or (32 if on_card else 8)
    ps = ecfg.page_size or (128 if on_card and gqa else 64)
    if ecfg.max_slots != 0:
        return dataclasses.replace(ecfg, decode_chunk=chunk, page_size=ps)
    slots = 64 if on_card and gqa else 32
    n_pages = ecfg.n_pages
    if n_pages is None:
        serve_seq = min(ecfg.max_seq_len, cfg.max_seq_len)
        ceil_slots = 24 if slots >= 64 else 8
        n_pages = max(1, ceil_slots * serve_seq // ps)
    return dataclasses.replace(ecfg, max_slots=slots, n_pages=n_pages,
                               decode_chunk=chunk, page_size=ps)


def resolve_engine_dtype(cfg: ModelConfig, device) -> str:
    """Weight serving dtype when the caller named none: the JAX package's
    ``resolve_engine_dtype`` with the card in the place of the TPU. On the
    card int8 weights below 4e9 parameters, int4 at 4e9 or more (room for
    the KV pool), bf16 for MoE expert stacks; f32 on the CPU."""
    if torch.device(device).type != "cuda":
        return "float32"
    if cfg.n_experts:
        return "bfloat16"
    return "int4" if cfg.n_params >= 4e9 else "int8"


def resolve_kv_dtype_default(device) -> torch.dtype:
    """int8 KV pool on the card (half the decode cache traffic), f32 on
    the CPU."""
    return (torch.int8 if torch.device(device).type == "cuda"
            else torch.float32)


CACHE_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
                "int8": torch.int8,
                # a string sentinel: the int4 pool has no storage dtype of
                # its own (nibble-packed uint8 codes + f32 scales)
                "int4": "int4"}


def resolve_cache_dtype(name_or_dtype) -> Union[torch.dtype, str]:
    """A KV cache dtype given by name or as a torch dtype → the engine's
    ``cache_dtype`` (a torch dtype, or "int4"); raises for anything
    outside the supported set."""
    if isinstance(name_or_dtype, str):
        if name_or_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache dtype {name_or_dtype!r}; expected one "
                             f"of {sorted(CACHE_DTYPES)}")
        return CACHE_DTYPES[name_or_dtype]
    if name_or_dtype not in CACHE_DTYPES.values():
        raise ValueError(f"unsupported cache dtype {name_or_dtype}")
    return name_or_dtype


def prefill_buckets(max_seq_len: int, min_bucket: int) -> List[int]:
    b, out = min_bucket, []
    while b < max_seq_len:
        out.append(b)
        b *= 2
    out.append(max_seq_len)
    return out


@dataclasses.dataclass
class SlotOptions:
    """Host-side per-request sampling options (Ollama API subset)."""
    temperature: float = 0.8
    top_k: int = 40
    top_p: float = 0.9
    min_p: float = 0.0
    typical_p: float = 1.0
    repeat_penalty: float = 1.1
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    seed: int = -1
    # penalty window for this request: 0 disables it, -1 means "engine
    # max"; values above the engine's repeat_last_n clamp
    repeat_last_n: int = 64


def _draw_seed(seed: int, position: int) -> int:
    """The generator seed for the draw at ``position`` of a stream seeded
    with ``seed``: a pure function of both, so a stream replays exactly
    whatever else shares the batch or how the chunks fall."""
    return (seed * 0x9E3779B1 + position * 0x85EBCA77 + 1) & ((1 << 63) - 1)


class DecodeHandle:
    """A launched decode dispatch. ``wait()`` returns its tokens [n, B]
    on the host once the device has run every step."""

    __slots__ = ("_toks", "_event", "_out", "epoch")

    def __init__(self, toks: torch.Tensor, event, epoch: int):
        self._toks = toks
        self._event = event
        self._out: Optional[np.ndarray] = None
        self.epoch = epoch

    def wait(self) -> np.ndarray:
        if self._out is None:
            if self._event is not None:
                self._event.synchronize()
            self._out = self._toks.cpu().numpy()
            self._toks = None
        return self._out


class Engine:
    """Owns the device state (params, page pools, slot state) and runs
    admissions and decode dispatches."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig =
                 EngineConfig(), device="cuda"):
        self.device = resolve_device(device)
        decoder.check_supported(cfg)
        self.cfg, self.ecfg, self.params = cfg, ecfg, params
        emb = params["tok_emb"]
        if emb.device.type != self.device.type:
            raise ValueError(f"params live on {emb.device}, the engine on "
                             f"{self.device}")
        if self.device.type == "cuda" and emb.dtype != torch.bfloat16:
            raise TypeError("on the card the engine serves bf16 "
                            "activations (int8/int4 weights, bf16 tok_emb)")
        B, S = ecfg.max_slots, min(ecfg.max_seq_len, cfg.max_seq_len)
        self.n_slots, self.max_seq = B, S
        ps = ecfg.page_size
        if ps <= 0 or ps & (ps - 1) or S % ps:
            raise ValueError(f"page_size {ps} must be a power of two "
                             f"dividing max_seq_len {S}")
        L, KvH, hd, V = (cfg.n_layers, cfg.n_kv_heads, cfg.head_dim,
                         cfg.vocab_size)
        self._nblk = S // ps
        n_pages = ecfg.n_pages or (B * S) // ps
        self._pt = PageTable(B, n_pages + 1, ps, self._nblk)
        dev = self.device
        shape = (L, n_pages + 1, KvH, ps, hd)
        cache_dtype = resolve_cache_dtype(ecfg.cache_dtype)
        if cache_dtype in (torch.int8, "int4"):
            # int4 packs two positions a byte along the page axis
            # (ops/quant_cache.py); scales stay per position, and zero
            # scales make an empty pool read as 0
            if cache_dtype == "int4" and ps < 2:
                raise ValueError("an int4 KV pool needs page_size >= 2")
            key, code_shape, code_dtype = (
                ("q4", shape[:3] + (ps // 2, hd), torch.uint8)
                if cache_dtype == "int4" else ("q", shape, torch.int8))

            def pool():
                return {key: torch.zeros(code_shape, dtype=code_dtype,
                                         device=dev),
                        "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                         device=dev)}
            self.k_cache, self.v_cache = pool(), pool()
        else:
            self.k_cache = torch.zeros(shape, dtype=cache_dtype, device=dev)
            self.v_cache = torch.zeros_like(self.k_cache)
        W = max(1, ecfg.repeat_last_n)
        self._W = W
        # device slot state. counts carries one sentinel column (index V)
        # that absorbs "no token" updates; sampling reads [:, :V]
        self.lengths = torch.zeros(B, dtype=torch.int32, device=dev)
        self.counts = torch.zeros((B, V + 1), dtype=torch.int32, device=dev)
        self.pring = torch.full((B, W), V, dtype=torch.int64, device=dev)
        self.last_tokens = torch.zeros(B, dtype=torch.int64, device=dev)
        # host mirrors
        self.active = np.zeros(B, bool)
        self._host_lengths = np.zeros(B, np.int64)
        self._repeat_n = np.full(B, W, np.int64)
        self._opts: Dict[int, SlotOptions] = {}
        self._seeds = np.zeros(B, np.int64)
        self._gens: List[Optional[torch.Generator]] = [None] * B
        self._admit_order = np.zeros(B, np.int64)
        self._admit_seq = 0
        self._buckets = prefill_buckets(S, ecfg.min_prefill_bucket)
        self._rebuild_slot_tensors()

    # ------------------------------------------------------------------
    # host API
    # ------------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return [i for i in range(self.n_slots) if not self.active[i]]

    def bucket_for(self, n: int) -> int:
        for b in self._buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt of {n} tokens exceeds max_seq_len "
                         f"{self.max_seq}")

    def _resolve_rln(self, opts: SlotOptions) -> int:
        r = opts.repeat_last_n
        return self._W if r < 0 else min(r, self._W)

    def _rebuild_slot_tensors(self):
        rows = [dataclasses.asdict(self._opts.get(i, SlotOptions()))
                for i in range(self.n_slots)]
        self.sp = sampling.SamplingParams.from_rows(rows, self.device)
        self._active_dev = torch.tensor(self.active, dtype=torch.int32,
                                        device=self.device)
        self._rln_dev = torch.tensor(self._repeat_n, dtype=torch.int64,
                                     device=self.device)

    def _generator(self, slot: int, position: int
                   ) -> Optional[torch.Generator]:
        g = self._gens[slot]
        if g is not None:
            g.manual_seed(_draw_seed(int(self._seeds[slot]), position))
        return g

    def can_admit(self, slot: int, n_tokens: int) -> bool:
        """Would admitting ``n_tokens`` into ``slot`` find enough pages,
        counting one decode chunk of headroom?"""
        ahead = min(n_tokens + self.ecfg.decode_chunk, self.max_seq)
        return (self._pt.blocks_for(ahead)
                <= self._pt.free_for(slot) + self._pt.owned_blocks(slot))

    def admissible(self, n_tokens: int) -> bool:
        """Could a prompt of ``n_tokens`` ever be admitted (pool empty)?"""
        ahead = min(n_tokens + self.ecfg.decode_chunk, self.max_seq)
        return self._pt.blocks_for(ahead) <= self._pt.data_pages

    def admit(self, slot: int, prompt: np.ndarray,
              opts: SlotOptions = SlotOptions()) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first sampled
        token. Raises :class:`PagesExhausted` when the pool cannot hold
        the prompt plus one decode chunk."""
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} busy")
        prompt = np.asarray(prompt, np.int64)
        n = int(prompt.shape[0])
        if not 0 < n < self.max_seq:
            raise ValueError(f"prompt of {n} tokens: need 0 < n < "
                             f"{self.max_seq}")
        bucket = self.bucket_for(n)
        table_row = self._grow_for_admit(slot, n)
        cfg, dev, V = self.cfg, self.device, self.cfg.vocab_size
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = prompt
        rln = self._resolve_rln(opts)
        # penalty window of the last rln prompt tokens: absolute position
        # p lands in ring slot p % rln (sentinel V elsewhere)
        W, rmod = self._W, max(rln, 1)
        ring = np.full(W, V, np.int64)
        counts = np.zeros(V + 1, np.int64)
        pos = np.arange(max(n - rln, 0), n)
        ring[pos % rmod] = prompt[pos]
        np.add.at(counts, prompt[pos], 1)
        seed = (opts.seed if opts.seed >= 0
                else (slot * 1000003 + n * 7919 + 12345) & 0x7FFFFFFF)
        self._seeds[slot] = seed
        self._gens[slot] = (torch.Generator(device=dev)
                            if opts.temperature > 0 else None)
        row = sampling.SamplingParams.from_rows([dataclasses.asdict(opts)],
                                                dev)
        x, ks, vs = decoder.prefill_hidden(
            self.params, cfg, torch.from_numpy(tokens).to(dev))
        logits = decoder._unembed(cfg, self.params, x[:, n - 1])
        counts_dev = torch.from_numpy(counts).to(dev)
        tok = int(sampling.sample(logits, counts_dev[None, :V], row,
                                  [self._generator(slot, n - 1)])[0])
        decoder.paged_insert(cfg, self.k_cache, self.v_cache, ks, vs,
                             table_row, n)
        # the first token enters the window at its own position n
        if rln > 0:
            counts[ring[n % rmod]] -= 1
            ring[n % rmod] = tok
            counts[tok] += 1
        self.lengths[slot] = n
        self.counts[slot] = torch.from_numpy(counts).to(dev,
                                                        torch.int32)
        self.pring[slot] = torch.from_numpy(ring).to(dev)
        self.last_tokens[slot] = tok
        self.active[slot] = True
        self._host_lengths[slot] = n
        self._opts[slot] = opts
        self._repeat_n[slot] = rln
        self._admit_seq += 1
        self._admit_order[slot] = self._admit_seq
        self._rebuild_slot_tensors()
        return tok

    def _grow_for_admit(self, slot: int, n: int) -> torch.Tensor:
        self._pt.release(slot)
        ahead = min(n + self.ecfg.decode_chunk, self.max_seq)
        if (self._pt.blocks_for(ahead) > self._pt.free_for(slot)
                or not self._pt.grow(slot, n)):
            raise PagesExhausted(
                f"prompt of {n} tokens (+1 chunk headroom) needs "
                f"{self._pt.blocks_for(ahead)} pages; "
                f"{self._pt.free_for(slot)} free")
        return torch.from_numpy(self._pt.tables[slot]).to(self.device)

    def prepare_decode(self, n: Optional[int] = None) -> List[int]:
        """Grow every active slot's table to cover lengths + n (clamped
        at max_seq), oldest admission first; returns the slots that found
        no pages, newest first, for the caller to preempt."""
        n = n or self.ecfg.decode_chunk
        order = sorted((s for s in range(self.n_slots) if self.active[s]),
                       key=lambda s: self._admit_order[s])
        victims = [s for s in order if not self._pt.grow(
            s, min(int(self._host_lengths[s]) + n, self.max_seq))]
        victims.reverse()
        return victims

    def _attn_bucket(self, n: int) -> int:
        """Smallest bucket covering every active slot for the next ``n``
        steps: the attended width of the dispatch."""
        need = int(self._host_lengths[self.active].max(initial=0)) + n
        for b in self._buckets:
            if need <= b:
                return b
        return self.max_seq

    def decode_n_launch(self, n: Optional[int] = None) -> DecodeHandle:
        """Enqueue ``n`` decode steps for every slot; slot state (host
        lengths included) advances at once and the handle's wait()
        returns the tokens [n, B]. Pages freed after this launch stay
        fenced until :meth:`retire` gets its epoch. Raises
        :class:`PagesExhausted` when the pool cannot cover the chunk —
        callers that preempt run :meth:`prepare_decode` themselves."""
        n = n or self.ecfg.decode_chunk
        victims = self.prepare_decode(n)
        if victims:
            raise PagesExhausted(f"pool dry; victims {victims}")
        cfg, dev, V = self.cfg, self.device, self.cfg.vocab_size
        nblk = -(-self._attn_bucket(n) // self.ecfg.page_size)
        tables = torch.from_numpy(self._pt.tables).to(dev)
        active = self._active_dev
        act_b = active.bool()
        live = act_b & (self._rln_dev > 0)
        rmod = self._rln_dev.clamp(min=1)
        sentinel = torch.full((self.n_slots,), V, dtype=torch.int64,
                              device=dev)
        ones = torch.ones((self.n_slots, 1), dtype=torch.int32, device=dev)
        toks = torch.empty((n, self.n_slots), dtype=torch.int64, device=dev)
        for t in range(n):
            logits, _, _ = decoder.forward_with_cache_paged(
                self.params, cfg, self.last_tokens[:, None],
                self.k_cache, self.v_cache, tables, self.lengths, nblk)
            gens = [self._generator(s, int(self._host_lengths[s]) + t)
                    if self.active[s] else None
                    for s in range(self.n_slots)]
            tok = sampling.sample(logits[:, 0], self.counts[:, :V],
                                  self.sp, gens)
            # penalty window: the new token sits at lengths + 1; evict
            # what held its ring slot rln tokens ago, then admit it
            slot_pos = ((self.lengths.long() + 1) % rmod)[:, None]
            evict = torch.where(act_b, self.pring.gather(1, slot_pos)[:, 0],
                                sentinel)
            new = torch.where(live, tok, sentinel)
            self.counts.scatter_add_(1, evict[:, None], -ones)
            self.counts.scatter_add_(1, new[:, None], ones)
            self.pring = torch.where(
                live[:, None], self.pring.scatter(1, slot_pos,
                                                  tok[:, None]),
                self.pring)
            self.lengths += active
            self.last_tokens = torch.where(act_b, tok, self.last_tokens)
            toks[t] = tok
        self._host_lengths[self.active] += n
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        return DecodeHandle(toks, event, self._pt.advance_epoch())

    def release(self, slot: int):
        """Free ``slot``: its pages return to the pool and its device
        state resets."""
        self.active[slot] = False
        self._opts.pop(slot, None)
        self._gens[slot] = None
        self._pt.release(slot)
        self._host_lengths[slot] = 0
        self._repeat_n[slot] = self._W
        self.lengths[slot] = 0
        self.counts[slot] = 0
        self.pring[slot] = self.cfg.vocab_size
        self.last_tokens[slot] = 0
        self._rebuild_slot_tensors()

    def retire(self, epoch: int):
        """The dispatch stamped ``epoch`` (and every earlier one) has been
        waited on: pages freed since then may be reused."""
        self._pt.retire_epoch(epoch)

    @property
    def kv_bytes(self) -> int:
        leaves = []
        for c in (self.k_cache, self.v_cache):
            leaves += list(c.values()) if isinstance(c, dict) else [c]
        return sum(t.numel() * t.element_size() for t in leaves)
