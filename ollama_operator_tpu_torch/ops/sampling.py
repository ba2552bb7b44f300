"""Token sampling, batched over slots.

Counterpart of ``ollama_operator_tpu/ops/sampling.py``: penalties, greedy,
temperature, top-k, locally-typical, top-p and min-p, with the filters in
a compressed top-1024 candidate space and evaluated at temperature 1
(llama.cpp's order); temperature only shapes the final draw. Mirostat v1
and v2 replace those filters with an adaptive truncation of the
temperature-scaled candidates (:func:`mirostat_keep`), driven by a per-slot
surprise budget ``mu`` that the engine carries and that each draw updates
(:func:`mirostat_update`) from the drawn token's surprise in the
renormalised truncated distribution (:func:`renormalised`).

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
_LN2 = 0.6931471805599453
_MIROSTAT_M = 100   # v1's Zipf-fit window (llama.cpp's default)


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
    mirostat: torch.Tensor       # i64; 0 off, 1/2 replace the filters
    mirostat_tau: torch.Tensor   # f32 target surprise (bits a token)
    mirostat_eta: torch.Tensor   # f32 learning rate of mu

    FIELDS = ("temperature", "top_k", "top_p", "min_p", "typical_p",
              "repeat_penalty", "presence_penalty", "frequency_penalty",
              "mirostat", "mirostat_tau", "mirostat_eta")

    @staticmethod
    def from_rows(rows: Sequence[dict], device) -> "SamplingParams":
        """Build the batched tensors from one dict of field values per
        slot (``top_k`` and ``mirostat`` integral, the rest float)."""
        def col(name):
            dt = (torch.int64 if name in ("top_k", "mirostat")
                  else torch.float32)
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


def mirostat_keep(scaled: torch.Tensor, sp: SamplingParams,
                  mu: torch.Tensor, V: int) -> torch.Tensor:
    """The mirostat truncation over the temperature-scaled candidate
    logits ``scaled`` [B, C] (sorted, unfiltered) → keep mask [B, C].

    v2 keeps the candidates whose surprise (-log2 p) is at most ``mu``;
    v1 keeps the first k, k from the Zipf exponent fitted over the head of
    the distribution (llama.cpp's ``llama_sampler_mirostat{,_v2}``, as the
    JAX package computes them). The first candidate is always kept."""
    B, C = scaled.shape
    pm = torch.softmax(scaled, dim=-1)
    surprise = -torch.log(pm.clamp(min=1e-30)) / _LN2
    m = min(_MIROSTAT_M, C)
    ar = torch.arange(1, m, dtype=torch.float32, device=scaled.device)
    t_i = torch.log((ar + 1) / ar)                               # [m-1]
    b_i = torch.log(pm[:, :m - 1].clamp(min=1e-30)
                    / pm[:, 1:m].clamp(min=1e-30))               # [B, m-1]
    s_hat = (t_i * b_i).sum(-1) / (t_i * t_i).sum()             # [B]
    eps = (s_hat - 1.0).clamp(min=1e-5)
    k1 = ((eps * torch.exp2(mu.clamp(max=60.0)))
          / (1.0 - float(V) ** (-eps))) ** (1.0 / s_hat.clamp(min=1e-5))
    k1 = torch.nan_to_num(k1, nan=float(C)).clamp(1.0, float(C))
    col = torch.arange(C, device=scaled.device)[None, :]
    keep1 = col < k1[:, None]
    keep2 = surprise <= mu[:, None]
    keep = torch.where((sp.mirostat == 2)[:, None], keep2, keep1)
    keep[:, 0] = True                                   # min_keep = 1
    return keep


def renormalised(filt: torch.Tensor) -> torch.Tensor:
    """The distribution a draw takes: the softmax of the kept candidates'
    logits (dropped ones at NEG_INF) [B, C]."""
    return torch.softmax(filt, dim=-1)


def mirostat_update(mu: torch.Tensor, probs: torch.Tensor,
                    ci: torch.Tensor, sp: SamplingParams) -> torch.Tensor:
    """mu' = mu - eta (e_obs - tau), e_obs the surprise (bits) of the
    drawn candidate ``ci`` [B] in the renormalised distribution ``probs``;
    only slots that sample under mirostat (mirostat > 0, temperature > 0)
    move."""
    p_sel = probs.gather(1, ci[:, None])[:, 0]
    e_obs = -torch.log(p_sel.clamp(min=1e-30)) / _LN2
    mu2 = mu - sp.mirostat_eta * (e_obs - sp.mirostat_tau)
    live = (sp.mirostat > 0) & (sp.temperature > 0.0)
    return torch.where(live, mu2, mu)


def sample(logits: torch.Tensor, token_counts: torch.Tensor,
           sp: SamplingParams,
           generators: Optional[Sequence[Optional[torch.Generator]]] = None,
           mu: Optional[torch.Tensor] = None,
           n_candidates: int = N_CANDIDATES):
    """logits [B, V] f32 → (tokens [B] int64, mu').

    Greedy (argmax of the penalised logits) for every slot whose
    ``generators`` entry is None — the engine leaves it None exactly
    where the temperature is <= 0 — and a filtered categorical draw from
    the slot's own generator for the rest. Slots with mirostat 1/2 draw
    from :func:`mirostat_keep`'s truncation of the temperature-scaled
    candidates in place of the static filters, and their ``mu`` ([B]
    f32, the surprise budgets) moves by :func:`mirostat_update`; every
    other entry of ``mu`` passes through. The engine passes ``mu`` None
    when no slot samples under mirostat: the truncation and the update
    are then skipped, and mu' is None. With no generator at all the call
    never leaves the greedy path (and never syncs the device)."""
    logits = apply_penalties(logits, token_counts, sp)
    greedy = torch.argmax(logits, dim=-1)
    if generators is None or all(g is None for g in generators):
        return greedy, mu
    B, V = logits.shape
    C = min(V, n_candidates)
    vals, cand = torch.topk(logits, C, dim=-1)
    filt = _filtered(vals, sp)
    t = sp.temperature.clamp(min=1e-6)[:, None]
    scaled = vals / t
    neg = torch.full_like(vals, NEG_INF)
    filt = torch.where(filt > NEG_INF / 2, scaled, neg)
    if mu is not None:
        keep_m = mirostat_keep(scaled, sp, mu, V)
        filt = torch.where((sp.mirostat > 0)[:, None],
                           torch.where(keep_m, scaled, neg), filt)
    probs = renormalised(filt)
    toks = greedy.clone()
    ci = (torch.zeros(B, dtype=torch.int64, device=logits.device)
          if mu is not None else None)
    for b, g in enumerate(generators):
        if g is not None:
            c = torch.multinomial(probs[b], 1, generator=g)[0]
            toks[b] = cand[b, c]
            if ci is not None:
                ci[b] = c
    if mu is None:
        return toks, None
    return toks, mirostat_update(mu, probs, ci, sp)
