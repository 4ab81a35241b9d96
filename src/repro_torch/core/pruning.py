"""Prefill-stage one-shot static pruning (§III-A.1) — the port of
`repro/core/pruning.py`."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import PruneConfig
from repro_torch.core.attention import chunked_causal_attention
from repro_torch.core.cache import KVCache, prefill_fill


def prefill_and_prune(cache: KVCache, q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor, prune: PruneConfig, chunk: int = 512,
                      length: Optional[torch.Tensor] = None,
                      ) -> Tuple[KVCache, torch.Tensor]:
    """q: [B,Hq,N,d]; k/v: [B,Hk,N,d] → (pruned cache, prefill out f32).

    `length` ([B] int32, optional): true prompt lengths of right-padded
    inputs — pad rows and columns neither attend, accumulate, nor enter the
    static top-k."""
    out, acc = chunked_causal_attention(
        q, k, v, chunk=chunk, obs_window=prune.prefill_obs_window,
        length=length)
    return prefill_fill(cache, k, v, acc, prune, length=length), out
