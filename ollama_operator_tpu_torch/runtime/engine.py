"""The serving engine: prefill and chunked decode over a paged KV pool or a
dense slot cache.

Counterpart of ``ollama_operator_tpu/runtime/engine.py`` on one device,
for its two caches. Paged (``EngineConfig.paged``): slots share a physical
page pool (int8 on the card by default, int4 on request). Dense: each slot
owns its rows of a head-first ``[L, B, KvH, S, hd]`` cache (bf16/f32, or
int8 codes with per-(position, head) f32 scales). Admissions prefill one
prompt in a power-of-two bucket and insert its K/V into the slot's pages
or rows, and every decode dispatch advances all slots ``decode_chunk``
steps. ``extend`` prefills only the tail of a prompt whose first
``start`` tokens already sit in the slot's cache: a parked conversation,
a prefix stitched from the radix tree, or the pieces of a chunked
prefill. On the paged pool the radix prefix cache (``runtime/radix.py``,
on unless ``TPU_PREFIX_CACHE`` is 0) takes finished prefixes
(``donate_prefix``) and maps them into later slots (``prefix_probe``,
``stitch``: full pages shared read-only, a partly matched boundary page
copied first). The surface the scheduler drives is the JAX engine's:
``admit``, ``extend``, ``decode_n_launch`` → ``DecodeHandle.wait``,
``prepare_decode``, ``release`` (``park``), ``can_admit``,
``admissible``, ``free_slots``, ``bucket_for``, the radix calls, and the
grammar calls (``set_mask``, ``clear_mask``, ``install_grammar``,
``step_budgets``, ``spec_ack``).

Grammar-constrained decoding (``ops/constrain.py``, ``ops/schema.py``) is
the JAX engine's design: each slot may carry a packed allowed-token row
that masks its logits before sampling, and a slot whose automaton state
lies in the installed device grammar table (``TPU_GRAMMAR_DEVICE``, on by
default; ``TPU_GRAMMAR_STATES`` states, 64 by default) reads its mask from
that table and advances its state on the device every step, so it keeps
the whole decode chunk; a host-masked slot takes one token a dispatch.
A batch with no constrained slot runs none of this.

PyTorch runs eagerly, so there is nothing to compile: a decode dispatch is
the host loop that enqueues ``n`` steps on the device, and its handle
waits on a CUDA event recorded after the last step (on the CPU the work is
done by the time the launch returns). Each slot carries a mirostat
surprise budget (``mu``, on the device), seeded to 2·tau at admission and
moved by every mirostat draw. A multimodal admission (``admit`` with
``embeds``) prefills from a spliced embedding sequence; its image
positions carry the pad id ``vocab_size``, which only the penalty counts'
sentinel column sees. The host arena of the prefix cache, speculative
decoding and multi-device meshes are not ported yet.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from ..device import resolve_device
from ..models import decoder
from ..models.config import ModelConfig, resolve_moe_impl
from ..ops import sampling
from ..ops.paged import paged_route, paged_shape_error
from .faults import FAULTS
from .paged import PageTable, PagesExhausted
from .radix import RadixCache


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Engine sizing. As in the JAX package, 0 in ``max_slots``,
    ``decode_chunk`` or ``page_size`` and None in ``paged`` mean "resolve
    per model and device" (:func:`resolve_serving_defaults`)."""
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
    # the paged KV pool (True) or the dense slot cache (False); the
    # server's model manager passes None = decide per model at load
    # (resolve_paged_default); direct engine constructions default dense
    paged: Optional[bool] = False
    page_size: int = 64
    # data pages in the pool (excl. the trash page); None = the dense
    # equivalent max_slots * max_seq_len / page_size
    n_pages: Optional[int] = None


def resolve_paged_default(cfg: ModelConfig, device) -> bool:
    """The serving default for an unset ``paged`` flag: the JAX package's
    ``resolve_paged_default`` with the card in the place of the TPU. GQA
    and MHA models page on the card, except that an MHA model stays dense
    when the v3 kernel is reverted (``TPU_PAGED_V3`` other than "1"); MoE
    stays dense, and every model is dense off the card, as the JAX package
    is dense off the TPU."""
    if torch.device(device).type != "cuda":
        return False
    if (cfg.n_kv_heads >= cfg.n_heads
            and os.environ.get("TPU_PAGED_V3", "1") != "1"):
        return False
    return not cfg.n_experts


def resolve_serving_defaults(ecfg: EngineConfig, cfg: ModelConfig,
                             device) -> EngineConfig:
    """The JAX package's ``resolve_serving_defaults`` with the card in the
    place of the TPU. ``paged`` None resolves per model
    (:func:`resolve_paged_default`); an explicit flag wins. Decode chunk
    32 on the card, 8 elsewhere. Paged: a GQA model on the card gets 64
    slots and page size 128, anything else 32 slots and page size 64;
    with auto slots and no explicit pool size the pool holds the dense-24
    (64 slots) or dense-8 (32 slots) byte ceiling (768 pages for llama3.1
    at max_seq_len 4096). Dense: 8 slots and no page pool.
    ``TPU_MIN_PREFILL_BUCKET``, when set, replaces the prefill-bucket
    floor."""
    on_card = torch.device(device).type == "cuda"
    gqa = cfg.n_kv_heads < cfg.n_heads
    chunk = ecfg.decode_chunk or (32 if on_card else 8)
    # the prefill-bucket floor: TPU_MIN_PREFILL_BUCKET when set (finer
    # chunked-prefill pieces on small-context models), as the JAX
    # resolver reads it
    minb = (int(os.environ.get("TPU_MIN_PREFILL_BUCKET", "0") or 0)
            or ecfg.min_prefill_bucket)
    if ecfg.paged is not None and ecfg.max_slots != 0:
        ps = ecfg.page_size or (128 if on_card and ecfg.paged and gqa
                                else 64)
        return dataclasses.replace(ecfg, decode_chunk=chunk, page_size=ps,
                                   min_prefill_bucket=minb)
    paged = (resolve_paged_default(cfg, device) if ecfg.paged is None
             else ecfg.paged)
    ps = ecfg.page_size or (128 if on_card and paged and gqa else 64)
    slots = ecfg.max_slots or ((64 if on_card and gqa else 32)
                               if paged else 8)
    n_pages = ecfg.n_pages
    if paged and n_pages is None and ecfg.max_slots == 0:
        serve_seq = min(ecfg.max_seq_len, cfg.max_seq_len)
        ceil_slots = 24 if slots >= 64 else 8
        n_pages = max(1, ceil_slots * serve_seq // ps)
    return dataclasses.replace(ecfg, paged=paged, max_slots=slots,
                               n_pages=n_pages, decode_chunk=chunk,
                               page_size=ps, min_prefill_bucket=minb)


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


def resolve_cache_dtype(name_or_dtype, device=None
                        ) -> Union[torch.dtype, str]:
    """A KV cache dtype given by name or as a torch dtype → the engine's
    ``cache_dtype`` (a torch dtype, or "int4"); raises for anything
    outside the supported set, and on the card for float32, which no
    decode kernel there takes (paged or dense: bf16, int8, int4)."""
    if isinstance(name_or_dtype, str):
        if name_or_dtype not in CACHE_DTYPES:
            raise ValueError(f"cache dtype {name_or_dtype!r}; expected one "
                             f"of {sorted(CACHE_DTYPES)}")
        name_or_dtype = CACHE_DTYPES[name_or_dtype]
    elif name_or_dtype not in CACHE_DTYPES.values():
        raise ValueError(f"unsupported cache dtype {name_or_dtype}")
    if (name_or_dtype is torch.float32 and device is not None
            and torch.device(device).type == "cuda"):
        raise ValueError("a float32 KV cache is not served on the card: "
                         "its decode kernels take bfloat16, int8 or int4 "
                         "(paged) caches")
    return name_or_dtype


def unpack_mask(mask_bits: torch.Tensor, V: int) -> torch.Tensor:
    """Packed [..., ceil(V/32)] words → bool [..., V] allowed-token mask.

    The words are the uint32 rows of ``ops/constrain.py`` held as int32
    bit patterns (an arithmetic shift still leaves bit k at position 0)."""
    shifts = torch.arange(32, dtype=torch.int32, device=mask_bits.device)
    bits = (mask_bits[..., None] >> shifts) & 1
    return bits.reshape(*mask_bits.shape[:-1], -1)[..., :V] != 0


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
    # mirostat: 0 off, 1/2 replace the static filters with the adaptive
    # surprise truncation (the slot's budget is Engine.mu)
    mirostat: int = 0
    mirostat_tau: float = 5.0
    mirostat_eta: float = 0.1
    seed: int = -1
    # penalty window for this request: 0 disables it, -1 means "engine
    # max"; values above the engine's repeat_last_n clamp
    repeat_last_n: int = 64


def _mirostat(opts: SlotOptions) -> bool:
    """Whether a slot's draws take the mirostat truncation (a greedy slot
    never draws, whatever its mirostat)."""
    return opts.mirostat > 0 and opts.temperature > 0


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


def _kv_arrays(shape, cache_dtype, dev):
    """K and V storage of ``shape`` (rows of hd on the last axis): plain
    bf16/f32 tensors, or {codes, f32 scales} dicts for int8 ("q") and
    int4 ("q4", two rows a byte along axis 3). Zero scales make an empty
    cache read as 0 (ops/quant_cache.py)."""
    if cache_dtype not in (torch.int8, "int4"):
        k = torch.zeros(shape, dtype=cache_dtype, device=dev)
        return k, torch.zeros_like(k)
    key, code_shape, code_dtype = (
        ("q4", shape[:3] + (shape[3] // 2, shape[4]), torch.uint8)
        if cache_dtype == "int4" else ("q", shape, torch.int8))

    def pool():
        return {key: torch.zeros(code_shape, dtype=code_dtype, device=dev),
                "s": torch.zeros(shape[:-1], dtype=torch.float32,
                                 device=dev)}
    return pool(), pool()


class DenseCache:
    """Each slot owns rows [0, S) of a head-first ``[L, B, KvH, S, hd]``
    cache (bf16/f32, or int8 codes with per-(position, head) f32 scales):
    admission writes a prompt's rows in place, nothing is allocated, and
    a prompt shorter than the context always fits."""
    pt = None

    def __init__(self, cfg: ModelConfig, B: int, S: int, cache_dtype, dev):
        if cache_dtype == "int4":
            raise ValueError("cache dtype 'int4' requires the paged cache "
                             "(the dense cache has no nibble-packed "
                             "layout); set paged=True or use int8")
        self.k, self.v = _kv_arrays(
            (cfg.n_layers, B, cfg.n_kv_heads, S, cfg.head_dim), cache_dtype,
            dev)

    def fits(self, slot: int, ahead: int) -> bool:
        return True

    def fits_empty(self, ahead: int) -> bool:
        return True

    def claim(self, slot: int, n: int, ahead: int):
        pass

    def insert(self, cfg: ModelConfig, ks, vs, slot: int, n: int):
        decoder.dense_insert(self.k, self.v, ks, vs, slot)

    def grow(self, slot: int, n_tokens: int) -> bool:
        return True

    def claim_extend(self, slot: int, n_total: int, ahead: int):
        pass

    def extend_hidden(self, params, cfg, tokens, slot: int, start,
                      attn_len: int):
        """An extend tail over the slot's first ``attn_len`` rows (a view:
        the writes land in the cache) → final hidden states."""
        def rows(c):
            return c[:, slot:slot + 1, :, :attn_len]
        k = ({n: rows(t) for n, t in self.k.items()}
             if isinstance(self.k, dict) else rows(self.k))
        v = ({n: rows(t) for n, t in self.v.items()}
             if isinstance(self.v, dict) else rows(self.v))
        x, _, _ = decoder.forward_with_cache(params, cfg, tokens, k, v,
                                             start, hidden=True)
        return x

    def stepper(self, attn_len: int):
        """One decode step over the first ``attn_len`` rows."""
        def step(params, cfg, tokens, lengths):
            return decoder.forward_with_cache(params, cfg, tokens, self.k,
                                              self.v, lengths, attn_len)
        return step

    def release(self, slot: int):
        """A released slot's rows stay as they are, masked until the next
        admission overwrites them."""

    def advance_epoch(self) -> int:
        return 0

    def retire(self, epoch: int):
        pass


class PagedCache:
    """Slots share a pool of ``[L, P, KvH, ps, hd]`` pages (page 0 is the
    trash page) through a :class:`PageTable`: admission and every decode
    dispatch grow a slot's table, released pages stay fenced until the
    dispatch that last read them is retired, and a dry pool raises
    :class:`PagesExhausted`."""

    def __init__(self, cfg: ModelConfig, B: int, S: int, ps: int,
                 n_pages: Optional[int], cache_dtype, dev):
        if ps <= 0 or ps & (ps - 1) or S % ps:
            raise ValueError(f"page_size {ps} must be a power of two "
                             f"dividing max_seq_len {S}")
        if cache_dtype == "int4" and ps < 2:
            raise ValueError("an int4 KV pool needs page_size >= 2")
        why = paged_shape_error(cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
                                ps, cache_dtype == "int4")
        if why and torch.device(dev).type == "cuda":
            raise ValueError(f"no paged-decode kernel on the card takes "
                             f"this pool ({paged_route()} route): {why}")
        n_pages = n_pages or (B * S) // ps
        self.pt = PageTable(B, n_pages + 1, ps, S // ps)
        self.dev = dev
        self.k, self.v = _kv_arrays(
            (cfg.n_layers, n_pages + 1, cfg.n_kv_heads, ps, cfg.head_dim),
            cache_dtype, dev)

    def fits(self, slot: int, ahead: int) -> bool:
        """Would ``ahead`` rows fit in the slot's pages plus the free
        ones?"""
        pt = self.pt
        return (pt.blocks_for(ahead)
                <= pt.free_for(slot) + pt.owned_blocks(slot))

    def fits_empty(self, ahead: int) -> bool:
        return self.pt.blocks_for(ahead) <= self.pt.data_pages

    def claim(self, slot: int, n: int, ahead: int):
        """Drop the slot's pages and map pages for an ``n``-token prompt,
        keeping ``ahead`` rows of headroom free."""
        pt = self.pt
        pt.release(slot)
        if pt.blocks_for(ahead) > pt.free_for(slot) or not pt.grow(slot, n):
            raise PagesExhausted(
                f"prompt of {n} tokens (+1 chunk headroom) needs "
                f"{pt.blocks_for(ahead)} pages; {pt.free_for(slot)} free")

    def insert(self, cfg: ModelConfig, ks, vs, slot: int, n: int):
        row = torch.from_numpy(self.pt.tables[slot]).to(self.dev)
        decoder.paged_insert(cfg, self.k, self.v, ks, vs, row, n)

    def grow(self, slot: int, n_tokens: int) -> bool:
        return self.pt.grow(slot, n_tokens)

    def claim_extend(self, slot: int, n_total: int, ahead: int):
        """Grow the slot's pages (its prefix kept) to cover an
        ``n_total``-token prompt, keeping ``ahead`` rows of headroom free;
        on a dry pool the slot's pages are released before
        :class:`PagesExhausted` is raised (nothing would reuse or evict
        them once the caller has taken the slot)."""
        pt = self.pt
        deficit = pt.blocks_for(ahead) - pt.owned_blocks(slot)
        if deficit > pt.free_for(slot) or not pt.grow(slot, n_total):
            pt.release(slot)
            raise PagesExhausted(
                f"extend to {n_total} tokens (+1 chunk headroom): "
                f"{pt.n_free} pages free")

    def extend_hidden(self, params, cfg, tokens, slot: int, start,
                      attn_len: int):
        """An extend tail over the pages covering the slot's first
        ``attn_len`` rows → final hidden states."""
        row = torch.from_numpy(self.pt.tables[slot]).to(self.dev)
        x, _, _ = decoder.forward_with_cache_paged(
            params, cfg, tokens, self.k, self.v, row[None], start,
            self.pt.blocks_for(attn_len), hidden=True)
        return x

    def copy_page(self, src: int, dst: int):
        """Copy-on-write: physical page ``src`` → ``dst`` in every layer
        and every leaf of both pools (codes, int8 scales, int4 packed
        rows; the page axis is axis 1 in each)."""
        for pool in (self.k, self.v):
            for t in (pool.values() if isinstance(pool, dict) else (pool,)):
                t[:, dst] = t[:, src]

    def stepper(self, attn_len: int):
        """One decode step over the pages covering ``attn_len`` rows."""
        nblk = self.pt.blocks_for(attn_len)
        tables = torch.from_numpy(self.pt.tables).to(self.dev)

        def step(params, cfg, tokens, lengths):
            return decoder.forward_with_cache_paged(
                params, cfg, tokens, self.k, self.v, tables, lengths, nblk)
        return step

    def release(self, slot: int):
        self.pt.release(slot)

    def advance_epoch(self) -> int:
        return self.pt.advance_epoch()

    def retire(self, epoch: int):
        self.pt.retire_epoch(epoch)


class Engine:
    """Owns the device state (params, KV pools or cache, slot state) and
    runs admissions and decode dispatches."""

    def __init__(self, cfg: ModelConfig, params, ecfg: EngineConfig =
                 EngineConfig(), device="cuda"):
        self.device = resolve_device(device)
        decoder.check_supported(cfg)
        if cfg.n_experts:
            cfg = dataclasses.replace(cfg, moe_impl=resolve_moe_impl(cfg))
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
        self.paged = bool(ecfg.paged)
        V = cfg.vocab_size
        cache_dtype = resolve_cache_dtype(ecfg.cache_dtype, self.device)
        dev = self.device
        self.kv = (PagedCache(cfg, B, S, ecfg.page_size, ecfg.n_pages,
                              cache_dtype, dev) if self.paged
                   else DenseCache(cfg, B, S, cache_dtype, dev))
        # radix prefix cache (paged only): finished prefixes are donated
        # to a page-granular tree that any later request can stitch;
        # TPU_PREFIX_CACHE=0 falls back to the scheduler's parked slots
        self._radix = (RadixCache(ecfg.page_size) if self.paged and
                       os.environ.get("TPU_PREFIX_CACHE", "1").lower()
                       not in ("0", "false") else None)
        W = max(1, ecfg.repeat_last_n)
        self._W = W
        # device slot state. counts carries one sentinel column (index V)
        # that absorbs "no token" updates; sampling reads [:, :V]
        self.lengths = torch.zeros(B, dtype=torch.int32, device=dev)
        self.counts = torch.zeros((B, V + 1), dtype=torch.int32, device=dev)
        self.pring = torch.full((B, W), V, dtype=torch.int64, device=dev)
        self.last_tokens = torch.zeros(B, dtype=torch.int64, device=dev)
        # mirostat surprise budgets, seeded to 2*tau at admission
        self.mu = torch.zeros(B, dtype=torch.float32, device=dev)
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
        # grammar-constraint state: packed per-slot allowed-token rows
        # (all ones + flag off = unconstrained; ops/constrain.py fills them)
        self.mask_words = (V + 31) // 32
        self.mask_bits = torch.full((B, self.mask_words), -1,
                                    dtype=torch.int32, device=dev)
        self._constrained = np.zeros(B, bool)
        self._constr_dev = torch.zeros(B, dtype=torch.bool, device=dev)
        # the device grammar program (ops/constrain.GrammarTable): gmask
        # [G, mask_words] holds the packed mask of each tabled automaton
        # state, gtrans [G, V] the successor state of each token (-1: the
        # walk leaves the table). Each slot carries a state: >= 0 device-
        # table mode (its mask is gmask[gstate], advanced on the device
        # after sampling), -1 host-mask mode (its mask_bits row, one token
        # a dispatch), -2 escaped (frozen until the host installs a fresh
        # mask through set_mask)
        self._gstates_cap = int(os.environ.get("TPU_GRAMMAR_STATES", "64"))
        self._grammar_device = os.environ.get(
            "TPU_GRAMMAR_DEVICE", "1").lower() not in ("0", "false")
        self._gmask_dev = torch.zeros((self._gstates_cap, self.mask_words),
                                      dtype=torch.int32, device=dev)
        self._gtrans_dev = torch.full((self._gstates_cap, V), -1,
                                      dtype=torch.int32, device=dev)
        self._gstate = torch.full((B,), -1, dtype=torch.int32, device=dev)
        self._gdev_mode = np.zeros(B, bool)   # host mirror: gstate >= 0
        self._gtable_key = None
        self._rebuild_slot_tensors()

    @property
    def k_cache(self):
        return self.kv.k

    @property
    def v_cache(self):
        return self.kv.v

    @property
    def _pt(self) -> Optional[PageTable]:
        return self.kv.pt

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
        # whether a decode step runs the mirostat truncation and update
        self._mirostat = any(map(_mirostat, self._opts.values()))
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

    def _ahead(self, n_tokens: int) -> int:
        """Rows an admission must find room for: the prompt plus one
        decode chunk of headroom, clamped at the context."""
        return min(n_tokens + self.ecfg.decode_chunk, self.max_seq)

    def can_admit(self, slot: int, n_tokens: int) -> bool:
        """Would admitting ``n_tokens`` into ``slot`` find room now (a
        prompt shorter than the context, and pages for it plus one decode
        chunk when paged)?"""
        return (0 < n_tokens < self.max_seq
                and self.kv.fits(slot, self._ahead(n_tokens)))

    def admissible(self, n_tokens: int) -> bool:
        """Could a prompt of ``n_tokens`` ever be admitted (pool empty)?"""
        return (0 < n_tokens < self.max_seq
                and self.kv.fits_empty(self._ahead(n_tokens)))

    def admit(self, slot: int, prompt: np.ndarray,
              opts: SlotOptions = SlotOptions(), embeds=None,
              mask_row: Optional[np.ndarray] = None) -> int:
        """Prefill ``prompt`` into ``slot``; returns the first sampled
        token, drawn under ``mask_row`` (a packed allowed-token row) when
        one is given. Paged: raises :class:`PagesExhausted` when the pool
        cannot hold the prompt plus one decode chunk.

        ``embeds`` [n, D] (numpy or a tensor): a precomputed embedding
        sequence for the prompt (multimodal: image tokens spliced between
        text embeddings), prefilled in place of the embedding lookup, which
        then never sees ``prompt``; its image positions carry a pad id
        (``vocab_size``) that only the penalty counts see."""
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} busy")
        prompt = np.asarray(prompt, np.int64)
        n = int(prompt.shape[0])
        if not 0 < n < self.max_seq:
            raise ValueError(f"prompt of {n} tokens: need 0 < n < "
                             f"{self.max_seq}")
        bucket = self.bucket_for(n)
        self.kv.claim(slot, n, self._ahead(n))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n] = prompt
        emb = None
        if embeds is not None:
            embeds = torch.as_tensor(embeds)
            if embeds.shape[0] != n:
                raise ValueError(f"embeds cover {embeds.shape[0]} positions, "
                                 f"the prompt {n}")
            emb = torch.zeros((1, bucket, embeds.shape[1]),
                              dtype=embeds.dtype, device=self.device)
            emb[0, :n] = embeds.to(self.device)
        x, ks, vs = decoder.prefill_hidden(
            self.params, self.cfg, torch.from_numpy(tokens).to(self.device),
            inputs_embeds=emb)
        tok = self._sample_install(slot, prompt, x[:, n - 1], opts,
                                   mask_row)
        self.kv.insert(self.cfg, ks, vs, slot, n)
        return tok

    def extend(self, slot: int, full_ids: np.ndarray, start: int,
               opts: SlotOptions = SlotOptions(),
               mask_row: Optional[np.ndarray] = None) -> int:
        """Admit ``full_ids`` into ``slot`` reusing its cached first
        ``start`` positions (a parked conversation, a stitched radix
        prefix, or the pieces a chunked prefill has written); prefills
        only the tail and returns the first sampled token (drawn under
        ``mask_row`` when one is given). It runs on
        every cache the port has (the paged pool: int8, int4, bf16/f32;
        the dense slot cache: bf16/f32, int8). The caller guarantees the slot's cache holds K/V for ``full_ids[:start]``;
        stale entries at positions >= start are never attended (masking
        is by position) and the tail overwrites them.

        The tail runs in bucket ``bucket_for(n_new)`` and attends the
        first ``bucket_for(start + bucket)`` positions (whole pages on the
        paged pool), so its cost scales with the conversation, not
        max_seq_len. The penalty window is rebuilt on the host over the
        full prompt. Paged: the slot grows to the prompt plus one decode
        chunk of headroom, and a dry pool releases the slot's pages
        before :class:`PagesExhausted` is raised."""
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} busy")
        full_ids = np.asarray(full_ids, np.int64)
        n_total = int(full_ids.shape[0])
        n_new = n_total - start
        if not 0 < n_new:
            raise ValueError(f"nothing to prefill (start={start}, "
                             f"{n_total} tokens)")
        if n_total >= self.max_seq:
            raise ValueError(f"prompt of {n_total} tokens: need n < "
                             f"{self.max_seq}")
        bucket = self.bucket_for(n_new)
        if start + bucket > self.max_seq:
            # the tail's padding positions run to start + bucket
            raise ValueError(f"tail bucket {bucket} does not fit above "
                             f"{start}")
        attn_len = self.bucket_for(start + bucket)
        self.kv.claim_extend(slot, n_total, self._ahead(n_total))
        tokens = np.zeros((1, bucket), np.int64)
        tokens[0, :n_new] = full_ids[start:]
        dev = self.device
        x = self.kv.extend_hidden(
            self.params, self.cfg, torch.from_numpy(tokens).to(dev), slot,
            torch.tensor([start], dtype=torch.int32, device=dev), attn_len)
        return self._sample_install(slot, full_ids, x[:, n_new - 1], opts,
                                    mask_row)

    def _sample_install(self, slot: int, prompt: np.ndarray, x_last,
                        opts: SlotOptions,
                        mask_row: Optional[np.ndarray] = None) -> int:
        """Shared admission tail of ``admit`` and ``extend``: the penalty
        window over the last ``rln`` prompt tokens, the slot's seed
        (from the slot and the full prompt length), the mirostat budget
        seeded to 2·tau, the first token sampled from the last prompt
        row's hidden state ``x_last`` [1, D] (its logits masked by
        ``mask_row`` when one is given; its surprise moves the budget) and
        pushed through the window, and the slot state installed."""
        cfg, dev, V = self.cfg, self.device, self.cfg.vocab_size
        n = int(prompt.shape[0])
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
        logits = decoder._unembed(cfg, self.params, x_last)
        if mask_row is not None:
            allowed = unpack_mask(self._words(mask_row), V)
            logits = logits.masked_fill(~allowed[None], sampling.NEG_INF)
        counts_dev = torch.from_numpy(counts).to(dev)
        self.mu[slot] = 2.0 * opts.mirostat_tau
        tok, mu = sampling.sample(
            logits, counts_dev[None, :V], row, [self._generator(slot, n - 1)],
            self.mu[slot:slot + 1] if _mirostat(opts) else None)
        tok = int(tok[0])
        if mu is not None:
            self.mu[slot] = mu[0]
        # the first token enters the window at its own position n
        if rln > 0:
            counts[ring[n % rmod]] -= 1
            ring[n % rmod] = tok
            counts[tok] += 1
        self.lengths[slot] = n
        self.counts[slot] = torch.from_numpy(counts).to(dev, torch.int32)
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

    def prepare_decode(self, n: Optional[int] = None) -> List[int]:
        """Grow every active slot's table to cover lengths + n (clamped
        at max_seq), oldest admission first; returns the slots that found
        no pages, newest first, for the caller to preempt (never any for
        the dense cache)."""
        n = n or self.ecfg.decode_chunk
        order = sorted((s for s in range(self.n_slots) if self.active[s]),
                       key=lambda s: self._admit_order[s])
        victims = [s for s in order if not self.kv.grow(
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
        returns the tokens [n, B]. Every slot row is computed, as in the
        JAX package (inactive rows write and attend their own position 0).
        Paged: pages freed after this launch stay fenced until
        :meth:`retire` gets its epoch; raises :class:`PagesExhausted` when
        the pool cannot cover the chunk — callers that preempt run
        :meth:`prepare_decode` themselves.

        With a constrained slot in the batch, each step masks the logits
        of the constrained slots (the device table's row for a slot in
        device-table mode, its host row otherwise), advances the device
        automaton by the sampled token (a transition out of the table
        escapes to -2, which freezes the slot for the rest of the
        dispatch), and freezes each slot once the step index reaches its
        budget (:meth:`step_budgets`). Host lengths advance by the
        budgets; the caller rolls back what an escaped slot did not use
        through :meth:`spec_ack`."""
        FAULTS.check("engine.step")
        n = n or self.ecfg.decode_chunk
        victims = self.prepare_decode(n)
        if victims:
            raise PagesExhausted(f"pool dry; victims {victims}")
        cfg, dev, V = self.cfg, self.device, self.cfg.vocab_size
        step = self.kv.stepper(self._attn_bucket(n))
        active = self._active_dev
        budgets = self.step_budgets(n)
        constrained = bool(self._constrained.any())
        if constrained:
            budgets_dev = torch.from_numpy(budgets).to(dev)
            G = self._gmask_dev.shape[0]
        else:
            act_b = active.bool()
            live = act_b & (self._rln_dev > 0)
        rmod = self._rln_dev.clamp(min=1)
        sentinel = torch.full((self.n_slots,), V, dtype=torch.int64,
                              device=dev)
        ones = torch.ones((self.n_slots, 1), dtype=torch.int32, device=dev)
        toks = torch.empty((n, self.n_slots), dtype=torch.int64, device=dev)
        for t in range(n):
            if constrained:
                # a slot freezes past its budget, and once it escaped
                active = (self._active_dev * (t < budgets_dev)
                          * (self._gstate != -2))
                act_b = active.bool()
                live = act_b & (self._rln_dev > 0)
            logits, _, _ = step(self.params, cfg, self.last_tokens[:, None],
                                self.lengths)
            last = logits[:, 0]
            if constrained:
                gdev = self._gstate >= 0
                gi = self._gstate.clamp(0, G - 1).long()
                eff = torch.where(gdev[:, None], self._gmask_dev[gi],
                                  self.mask_bits)
                last = last.masked_fill(
                    self._constr_dev[:, None] & ~unpack_mask(eff, V),
                    sampling.NEG_INF)
            gens = [self._generator(s, int(self._host_lengths[s]) + t)
                    if self.active[s] else None
                    for s in range(self.n_slots)]
            tok, mu = sampling.sample(last, self.counts[:, :V], self.sp,
                                      gens, self.mu if self._mirostat
                                      else None)
            if mu is not None:
                self.mu = torch.where(act_b, mu, self.mu)
            if constrained:
                ns = self._gtrans_dev[gi, tok]
                ns = torch.where(ns < 0, torch.full_like(ns, -2), ns)
                self._gstate = torch.where(gdev & act_b, ns, self._gstate)
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
        self._host_lengths[self.active] += budgets[self.active]
        event = None
        if dev.type == "cuda":
            event = torch.cuda.Event()
            event.record()
        epoch = self.kv.advance_epoch()
        return DecodeHandle(toks, event, epoch)

    # ------------------------------------------------------------------
    # grammar masks
    # ------------------------------------------------------------------
    def _pad_mask_row(self, row) -> np.ndarray:
        """Zero-pad a packed mask to the engine's width: ids beyond the
        grammar's token table are unknown to it and stay disallowed."""
        row = np.asarray(row, np.uint32)
        if row.shape[0] == self.mask_words:
            return row
        if row.shape[0] > self.mask_words:
            raise ValueError(f"mask row of {row.shape[0]} words exceeds the "
                             f"vocabulary ({self.mask_words} words)")
        out = np.zeros((self.mask_words,), np.uint32)
        out[:row.shape[0]] = row
        return out

    def _words(self, row) -> torch.Tensor:
        """A packed host row → its int32 bit patterns on the device."""
        return torch.from_numpy(
            self._pad_mask_row(row).view(np.int32)).to(self.device)

    def set_mask(self, slot: int, row: np.ndarray, gid: int = -1):
        """Install the packed allowed-token mask for ``slot`` (applies from
        the next decode step; constrained until release/clear_mask).

        ``gid`` >= 0 also places the slot in device-table mode: its mask
        is read from row ``gid`` of the installed grammar table and its
        automaton advances on the device with every sampled token, so the
        slot keeps the whole decode chunk. The host row still installs as
        the mask the slot falls back to when it escapes the table."""
        self._constrained[slot] = True
        self._gdev_mode[slot] = gid >= 0
        self.mask_bits[slot] = self._words(row)
        self._constr_dev[slot] = True
        self._gstate[slot] = gid

    def clear_mask(self, slot: int):
        if not self._constrained[slot]:
            return
        self._constrained[slot] = False
        self._gdev_mode[slot] = False
        self.mask_bits[slot] = -1
        self._constr_dev[slot] = False
        self._gstate[slot] = -1

    def install_grammar(self, key, mask: np.ndarray,
                        trans: np.ndarray) -> bool:
        """Upload a grammar program (``GrammarTable.mask``/``.trans``) to
        the device tables. ``key`` names the table; a matching key is a
        no-op. Returns False (the scheduler then uses host masks) when
        device tables are off, or when a different table is live while a
        slot still runs in device-table mode (swapping it under them
        would corrupt their automata). Rows and columns beyond the
        [TPU_GRAMMAR_STATES, vocab] capacity are cut; a transition into a
        state beyond the capacity becomes an escape (-1)."""
        if not self._grammar_device:
            return False
        if self._gtable_key == key:
            return True
        if self._gdev_mode.any():
            return False
        G, V = self._gstates_cap, self.cfg.vocab_size
        mask = np.asarray(mask, np.uint32)[:G]
        trans = np.asarray(trans, np.int32)[:G]
        m = np.zeros((G, self.mask_words), np.uint32)
        m[:mask.shape[0], :min(mask.shape[1], self.mask_words)] = \
            mask[:, :self.mask_words]
        t = np.full((G, V), -1, np.int32)
        t[:trans.shape[0], :min(trans.shape[1], V)] = trans[:, :V]
        t[t >= G] = -1
        self._gmask_dev = torch.from_numpy(m.view(np.int32)).to(self.device)
        self._gtrans_dev = torch.from_numpy(t).to(self.device)
        self._gtable_key = key
        return True

    def step_budgets(self, n: int) -> np.ndarray:
        """Per-slot step budget for a dispatch of ``n`` steps: host-masked
        constrained slots advance one token a dispatch (their mask
        refreshes on the host between dispatches); device-table slots and
        everyone else take the whole dispatch."""
        host_masked = self._constrained & ~self._gdev_mode
        return np.where(host_masked, 1, n).astype(np.int64)

    def spec_ack(self, rollback: np.ndarray) -> None:
        """Take back the per-slot host-length advance a dispatch did not
        use (the steps after a device-table slot escaped, which froze it).
        The name is the JAX engine's, whose speculative decoding rolls
        back the same way. Inactive slots are masked out, and no length
        goes below 0."""
        rb = np.asarray(rollback, np.int64)
        rb = np.minimum(np.where(self.active, rb, 0), self._host_lengths)
        self._host_lengths -= rb

    def release(self, slot: int, park: bool = False):
        """Free ``slot``: its pages return to the pool and its device
        state resets (a dense slot's rows stay as they are, masked until
        the next admission overwrites them). With ``park`` the cache,
        pages and lengths stay, so that a later ``extend`` can reuse the
        prefix: the slot goes inactive (decode dispatches skip it) and
        counts as free, and any admission may overwrite it. Either way
        its grammar mask is cleared."""
        self.clear_mask(slot)
        self.active[slot] = False
        self._opts.pop(slot, None)
        self._gens[slot] = None
        if park:
            self._rebuild_slot_tensors()
            return
        self.kv.release(slot)
        self._host_lengths[slot] = 0
        self._repeat_n[slot] = self._W
        self.lengths[slot] = 0
        self.counts[slot] = 0
        self.pring[slot] = self.cfg.vocab_size
        self.last_tokens[slot] = 0
        self._rebuild_slot_tensors()

    def free_slot_pages(self, slot: int):
        """Drop a parked (inactive) slot's pages back to the pool: the
        scheduler evicts parked prefixes with this under pool pressure."""
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} is active")
        self.kv.release(slot)

    # ------------------------------------------------------------------
    # radix prefix cache (paged)
    # ------------------------------------------------------------------
    @property
    def radix_enabled(self) -> bool:
        return self._radix is not None

    @property
    def radix_pages(self) -> int:
        """Physical pages pinned by the radix tree."""
        return self._radix.n_pages if self._radix is not None else 0

    def prefix_probe(self, full_ids) -> int:
        """How many leading tokens of ``full_ids`` the radix tree could
        serve (full pages and one partly matched boundary page), capped
        at len - 1 so one tail token remains to prefill; LRU stamps are
        left alone. 0 when the cache is off or cold."""
        if self._radix is None:
            return 0
        ids = np.asarray(full_ids)
        full, _, q = self._radix.match(ids, int(ids.shape[0]) - 1,
                                       bump=False)
        return len(full) * self.ecfg.page_size + q

    def stitch(self, slot: int, full_ids, max_reuse: int) -> int:
        """Map the radix tree's longest prefix of ``full_ids`` (at most
        ``max_reuse`` tokens) into ``slot``'s block table ahead of an
        ``extend``: whole-page hits are shared read-only (a refcount, no
        copy); a partly matched boundary page is copied into a private
        page first (copy-on-write), since the tail writes the rest of
        that page. Any pages the slot still held are dropped first.
        Returns the reuse length stitched (0 = cold). Raises
        :class:`PagesExhausted` when the boundary page finds no free page,
        leaving the slot with no pages, so the caller can fall back to a
        cold admission."""
        if self._radix is None:
            raise RuntimeError("the radix prefix cache is off")
        if self.active[slot]:
            raise RuntimeError(f"slot {slot} busy")
        pt = self._pt
        pt.release(slot)
        ids = np.asarray(full_ids)
        cap = min(int(max_reuse), int(ids.shape[0]) - 1)
        if cap <= 0:
            return 0
        full, part, q = self._radix.match(ids, cap, bump=True)
        if not full and q == 0:
            return 0
        pt.map_shared(slot, [n.page for n in full])
        reuse = len(full) * self.ecfg.page_size
        if part is not None and q > 0:
            if pt.n_free < 1:
                self.radix_evict(1)
            if not pt.grow(slot, reuse + q):
                pt.release(slot)
                raise PagesExhausted(f"no page for the copy-on-write "
                                     f"boundary ({pt.n_free} free)")
            self.kv.copy_page(part.page, pt.slot_pages(slot)[-1])
            reuse += q
        return reuse

    def donate_prefix(self, slot: int, token_ids) -> int:
        """Give ``slot``'s full-page prefix of ``token_ids`` to the radix
        tree, then release the slot. Chunks the tree did not hold adopt
        the slot's pages (pinned: they survive the release); chunks it
        held keep the tree's page, and the slot's copy goes back to the
        pool. Returns the tokens donated (0, and a plain release, when the
        cache is off)."""
        if self._radix is None:
            self.release(slot)
            return 0
        ids = np.asarray(token_ids)
        ps = self.ecfg.page_size
        k = min(int(ids.shape[0]) // ps, self._pt.owned_blocks(slot))
        if k > 0:
            for node in self._radix.insert(ids[:k * ps],
                                           self._pt.slot_pages(slot)[:k]):
                self._pt.pin(node.page)
        self.release(slot)
        return k * ps

    def radix_reset(self):
        """Drop the whole radix tree (supervised restart: the cache's
        contents are unknown after a failed step, so nothing may be
        reused); its pages go back to the pool."""
        if self._radix is None:
            return
        for pg in self._radix.reset():
            self._pt.unpin(pg)

    def drain_quarantine(self) -> int:
        """Return every fenced page to the pool without waiting on a
        handle (supervised restart: the failed dispatch is never waited,
        and any program still running on the stream finishes before a
        later one reads a recycled page). Returns the pages freed."""
        return self._pt.drain_quarantine() if self._pt is not None else 0

    @property
    def free_pages(self) -> int:
        """Pages on the pool's free list (0 for the dense cache)."""
        return self._pt.n_free if self._pt is not None else 0

    def radix_evict(self, n_pages: int = 1) -> int:
        """Evict up to ``n_pages`` least-recently-used radix leaves whose
        pages no slot maps, page by page (children before parents); their
        pages go back to the pool through the epoch fence. Returns the
        pages freed."""
        if self._radix is None:
            return 0
        pages = self._radix.evict(
            n_pages, lambda pg: self._pt.shared_refs(pg) == 0)
        for pg in pages:
            self._pt.unpin(pg)
        return len(pages)

    def retire(self, epoch: int):
        """The dispatch stamped ``epoch`` (and every earlier one) has been
        waited on: pages freed since then may be reused (paged only)."""
        self.kv.retire(epoch)

    @property
    def kv_bytes(self) -> int:
        leaves = []
        for c in (self.k_cache, self.v_cache):
            leaves += list(c.values()) if isinstance(c, dict) else [c]
        return sum(t.numel() * t.element_size() for t in leaves)
