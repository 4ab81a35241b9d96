"""Approximate similarity scoring (CAM mode) and the charge-domain
accumulation — the port of `repro/core/scoring.py`.

    score[b,h,s] = (Σ_d qq[b,h,d]·kq[b,h,s,d]) · qscale[b,h] · kscale[b,h,s]
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.topk import NEG_INF


def approx_scores(qq: torch.Tensor, qscale: torch.Tensor, kq: torch.Tensor,
                  kscale: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """qq [B,Hq,d] int8, qscale [B,Hq], kq [B,Hk,S,d] int8, kscale [B,Hk,S],
    valid [B,Hk,S] bool → [B,Hq,S] f32 scores, NEG_INF at invalid slots.

    The contraction is exact: |code| <= 127 and d <= 128 keep every partial
    sum below 2^24, so it runs as an f32 product of the integer codes (CUDA
    has no int32 batched matmul) and equals the reference's int32 one."""
    b, hq, d = qq.shape
    _, hk, s, _ = kq.shape
    g = hq // hk
    raw = torch.matmul(qq.reshape(b, hk, g, d).float(),
                       kq.float().transpose(-1, -2))          # [B,Hk,G,S]
    scores = (raw * qscale.reshape(b, hk, g)[..., None]
              * kscale[:, :, None, :])
    scores = torch.where(valid[:, :, None, :], scores,
                         torch.full_like(scores, NEG_INF))
    return scores.reshape(b, hq, s)


def exact_scores(q: torch.Tensor, k: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Full-precision scores: q [B,Hq,d], k [B,Hk,S,d] → [B,Hq,S]."""
    b, hq, d = q.shape
    _, hk, s, _ = k.shape
    g = hq // hk
    raw = torch.matmul(q.reshape(b, hk, g, d).float(),
                       k.float().transpose(-1, -2))
    raw = torch.where(valid[:, :, None, :], raw, torch.full_like(raw, NEG_INF))
    return raw.reshape(b, hq, s)


def score_probs(scores: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Masked softmax over slots: scores [B,Hq,S] → probs [B,Hq,S]."""
    logits = scores / math.sqrt(head_dim)
    logits = logits - logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits) * (scores > NEG_INF / 2)
    z = e.sum(dim=-1, keepdim=True)
    return e / torch.clamp(z, min=1e-30)


def accumulate(acc: torch.Tensor, probs: torch.Tensor, n_kv_heads: int,
               decay: float = 1.0) -> torch.Tensor:
    """Fold one step's probabilities [B,Hq,S] into the per-(kv-head, slot)
    accumulated-score table acc [B,Hk,S]."""
    b, hq, s = probs.shape
    step = probs.reshape(b, n_kv_heads, hq // n_kv_heads, s).sum(dim=2)
    return acc * decay + step
