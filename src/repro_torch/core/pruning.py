"""Prefill-stage one-shot static pruning (§III-A.1) — the port of
`repro/core/pruning.py`."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import PruneConfig
from repro_torch.core.attention import chunked_causal_attention
from repro_torch.core.cache import KVCache, prefill_fill
from repro_torch.core.quant import mirror_bytes_per_token


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


def memory_footprint_bytes(n_tokens: int, n_kv_heads: int, head_dim: int,
                           prune: PruneConfig, kv_bytes: int = 2) -> int:
    """Per-layer KV bytes under a policy (paper Fig. 10 'device count').

    dense: grows with n_tokens; pruned policies: fixed S=H+M slots (+ the
    quantized mirror for unicaim, at `quant.mirror_bytes_per_token`'s
    packing) and an f32 accumulated-score table a slot."""
    if prune.policy == "dense":
        tokens, mirror = n_tokens, 0
    else:
        tokens = min(n_tokens, prune.slots)
        mirror = 0
        if prune.policy == "unicaim":
            mirror = tokens * n_kv_heads * mirror_bytes_per_token(
                head_dim, prune.score_bits)
    kv = 2 * tokens * n_kv_heads * head_dim * kv_bytes
    acc_table = 0 if prune.policy == "dense" else tokens * n_kv_heads * 4
    return kv + mirror + acc_table
