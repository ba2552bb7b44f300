"""Token sampling, batched over slots.

Counterpart of ``ollama_operator_tpu/ops/sampling.py``: penalties, greedy,
temperature, top-k, locally-typical, top-p and min-p, with the filters in
a compressed top-1024 candidate space and evaluated at temperature 1
(llama.cpp's order); temperature only shapes the final draw. Mirostat is
not ported yet.

Randomness comes from one ``torch.Generator`` per sampled slot, which the
engine reseeds from the request's seed and the token's position before
each draw. Seeded streams therefore replay exactly within the port, but
they cannot match the JAX package's threefry bits: greedy decoding is
where the two are compared token for token, and a seeded stream's check
is that it repeats itself.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch

NEG_INF = -1e30
N_CANDIDATES = 1024


@dataclasses.dataclass
class SamplingParams:
    """Per-slot sampling parameters, each a [B] tensor."""

    temperature: torch.Tensor    # f32; <= 0 → greedy
    top_k: torch.Tensor          # i64; <= 0 → off
    top_p: torch.Tensor          # f32; >= 1 → off
    min_p: torch.Tensor          # f32; <= 0 → off
    typical_p: torch.Tensor      # f32; >= 1 → off
    repeat_penalty: torch.Tensor     # f32; 1.0 → off
    presence_penalty: torch.Tensor   # f32
    frequency_penalty: torch.Tensor  # f32

    FIELDS = ("temperature", "top_k", "top_p", "min_p", "typical_p",
              "repeat_penalty", "presence_penalty", "frequency_penalty")

    @staticmethod
    def from_rows(rows: Sequence[dict], device) -> "SamplingParams":
        """Build the batched tensors from one dict of field values per
        slot (``top_k`` integral, the rest float)."""
        def col(name):
            dt = torch.int64 if name == "top_k" else torch.float32
            return torch.tensor([r[name] for r in rows], dtype=dt,
                                device=device)
        return SamplingParams(**{f: col(f) for f in SamplingParams.FIELDS})


def apply_penalties(logits: torch.Tensor, token_counts: torch.Tensor,
                    sp: SamplingParams) -> torch.Tensor:
    """logits [B, V] f32; token_counts [B, V] int (counts in the window)."""
    seen = token_counts > 0
    rp = sp.repeat_penalty[:, None]
    penalised = torch.where(logits > 0, logits / rp, logits * rp)
    logits = torch.where(seen, penalised, logits)
    logits = logits - sp.presence_penalty[:, None] * seen.float()
    logits = logits - sp.frequency_penalty[:, None] * token_counts.float()
    return logits


def _filtered(vals: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """The top-k / typical / top-p / min-p mask over sorted candidate
    logits ``vals`` [B, C] (at temperature 1), as logits with the
    dropped candidates at NEG_INF."""
    B, C = vals.shape
    neg = torch.full_like(vals, NEG_INF)
    k = sp.top_k.clamp(1, C)
    kth = vals.gather(1, (k - 1)[:, None])
    keep = (vals >= kth) | (sp.top_k <= 0)[:, None]
    filt = torch.where(keep, vals, neg)

    probs = torch.softmax(filt, dim=-1)
    nlp = -torch.log(probs.clamp(min=1e-30))
    ent = torch.where(probs > 0, probs * nlp, torch.zeros_like(probs)
                      ).sum(dim=-1, keepdim=True)
    order = torch.argsort((nlp - ent).abs(), dim=-1, stable=True)
    p_ord = probs.gather(1, order)
    cum = torch.cumsum(p_ord, dim=-1)
    keep_ord = (cum - p_ord) < sp.typical_p[:, None]
    keep_ord[:, 0] = True                               # min_keep = 1
    keep = torch.zeros_like(keep_ord).scatter(1, order, keep_ord)
    keep = keep | (sp.typical_p >= 1.0)[:, None]
    filt = torch.where(keep, filt, neg)

    probs = torch.softmax(filt, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = ((cum - probs) < sp.top_p[:, None]) | (sp.top_p >= 1.0)[:, None]
    filt = torch.where(keep, filt, neg)

    probs = torch.softmax(filt, dim=-1)
    keep = probs >= sp.min_p[:, None] * probs.amax(dim=-1, keepdim=True)
    keep = keep | (sp.min_p <= 0.0)[:, None]
    return torch.where(keep, filt, neg)


def sample(logits: torch.Tensor, token_counts: torch.Tensor,
           sp: SamplingParams,
           generators: Optional[Sequence[Optional[torch.Generator]]] = None,
           n_candidates: int = N_CANDIDATES) -> torch.Tensor:
    """logits [B, V] f32 → tokens [B] int64.

    Greedy (argmax of the penalised logits) for every slot whose
    ``generators`` entry is None — the engine leaves it None exactly
    where the temperature is <= 0 — and a filtered categorical draw from
    the slot's own generator for the rest. With no generator at all the
    call never leaves the greedy path (and never syncs the device)."""
    logits = apply_penalties(logits, token_counts, sp)
    greedy = torch.argmax(logits, dim=-1)
    if generators is None or all(g is None for g in generators):
        return greedy
    B, V = logits.shape
    C = min(V, n_candidates)
    vals, cand = torch.topk(logits, C, dim=-1)
    filt = _filtered(vals, sp)
    t = sp.temperature.clamp(min=1e-6)[:, None]
    scaled = torch.where(filt > NEG_INF / 2, vals / t,
                         torch.full_like(vals, NEG_INF))
    probs = torch.softmax(scaled, dim=-1)
    toks = greedy.clone()
    for b, g in enumerate(generators):
        if g is not None:
            ci = torch.multinomial(probs[b], 1, generator=g)
            toks[b] = cand[b, ci[0]]
    return toks
