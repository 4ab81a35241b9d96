"""Top-k selection — the port of `repro/core/topk.py`.

Two selection mechanisms, both on the approximate scores: `exact_topk`
(exactly k indices, for the gather + exact-attention path) and
`threshold_race` (the CAM discharge race: a binary search of a score
threshold so that about k entries survive, as a mask).

`lax.top_k` returns the lowest index first among equal values, and the fused
kernels say the same ("first max wins"). `torch.topk` promises no order
among ties, so `exact_topk` is a stable descending sort instead.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def exact_topk(scores: torch.Tensor, k: int):
    """Top-k over the last axis → (values, indices [..., k]); ties go to the
    lower index, as in `lax.top_k`."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def block_candidates(scores: torch.Tensor, k: int,
                     offset: int) -> torch.Tensor:
    """One block's candidates for a race over slots split into blocks:
    its top min(k, S) scores (ties to the lower slot) and their global
    slots (`offset` + local), as f64 pairs [..., min(k, S), 2] (exact for
    an f32 score and a slot below 2^53)."""
    vals, idx = exact_topk(scores, min(k, scores.shape[-1]))
    return torch.stack([vals.double(), (idx + offset).double()], dim=-1)


def merge_candidates(cands: torch.Tensor, k: int) -> torch.Tensor:
    """The global top-k from every block's `block_candidates`, cands [n,
    ..., kc, 2] in block order → global slots [..., k] int64, the set
    `exact_topk` gives over the whole axis: equal scores lie in global slot
    order (block by block, each block's in slot order), and the stable
    sort keeps that order."""
    flat = torch.movedim(cands, 0, -3)                     # [..., n, kc, 2]
    flat = flat.reshape(flat.shape[:-3] + (-1, 2))          # [..., n·kc, 2]
    _, pos = exact_topk(flat[..., 0], k)
    return torch.gather(flat[..., 1], -1, pos).long()


def threshold_race(scores: torch.Tensor, k, iters: int = 8,
                   eligible: Optional[torch.Tensor] = None) -> torch.Tensor:
    """CAM-style selection: binary-search a threshold so ~k survive.

    Returns a boolean mask over the last axis with >= 1 (when anything is
    eligible) and ~k True entries. `k` is an int or an integer tensor
    broadcastable against the [..., 1] count (per-row targets).
    `eligible` ([..., S] bool, optional) restricts both the search range
    and the mask to those entries, so that the ±1e30 sentinels of
    `apply_selection_bias` do not blow the threshold's resolution; the
    caller unions the protected mask back in. Same f32 arithmetic as the
    reference (`mid = 0.5 * (lo + hi)`), so the masks are equal."""
    if eligible is None:
        lo = scores.amin(dim=-1, keepdim=True)
        hi = scores.amax(dim=-1, keepdim=True)
    else:
        inf = torch.full_like(scores, float("inf"))
        lo = torch.where(eligible, scores, inf).amin(dim=-1, keepdim=True)
        hi = torch.where(eligible, scores, -inf).amax(dim=-1, keepdim=True)
        # no eligible entry → an empty range; the mask comes out empty
        lo = torch.where(torch.isfinite(lo), lo, torch.zeros_like(lo))
        hi = torch.where(torch.isfinite(hi), hi, torch.zeros_like(hi))

    def count_ge(thr):
        ge = scores >= thr
        return ge & eligible if eligible is not None else ge

    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        more = count_ge(mid).sum(dim=-1, keepdim=True) > k
        # too many survivors → raise the threshold; too few → lower it
        lo, hi = torch.where(more, mid, lo), torch.where(more, hi, mid)
    top = (scores if eligible is None else torch.where(
        eligible, scores, torch.full_like(scores, -float("inf"))))
    # the max always survives
    return count_ge(lo) | count_ge(top.amax(dim=-1, keepdim=True))


def gqa_group_scores(scores: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """Sum per-q-head scores within each GQA group: [..., Hq, S] → [..., Hk, S]."""
    *lead, hq, s = scores.shape
    assert hq % n_kv_heads == 0
    g = hq // n_kv_heads
    return scores.reshape(*lead, n_kv_heads, g, s).sum(dim=-2)


def apply_selection_bias(scores: torch.Tensor, protected: torch.Tensor,
                         invalid: torch.Tensor) -> torch.Tensor:
    """Protected slots always win the race; invalid slots never do."""
    scores = torch.where(protected, torch.full_like(scores, 1e30), scores)
    return torch.where(invalid, torch.full_like(scores, NEG_INF), scores)


def indices_to_mask(indices: torch.Tensor, size: int) -> torch.Tensor:
    """[..., k] integer indices → [..., size] boolean membership mask."""
    mask = torch.zeros(indices.shape[:-1] + (size,), dtype=torch.bool,
                       device=indices.device)
    return mask.scatter_(-1, indices.long(), True)
