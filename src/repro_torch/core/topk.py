"""Top-k selection — the port of `repro/core/topk.py` (exact top-k path).

`lax.top_k` returns the lowest index first among equal values, and the fused
kernels say the same ("first max wins"). `torch.topk` promises no order
among ties, so `exact_topk` is a stable descending sort instead.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def exact_topk(scores: torch.Tensor, k: int):
    """Top-k over the last axis → (values, indices [..., k]); ties go to the
    lower index, as in `lax.top_k`."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


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
