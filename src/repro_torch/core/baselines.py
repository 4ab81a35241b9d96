"""Baseline KV-cache policies (a copy of the reference package's
`core/baselines.py`) the paper compares against (Table I, Fig. 13).

All baselines run on the same fixed-slot cache machinery — they differ only
in scoring precision, selection, and eviction rule:

  dense        — no pruning; cache sized to the full sequence.
  streaming    — StreamingLLM [19]: attention sinks + sliding window
                 (position-based ring eviction, no scores).
  h2o          — H2O [7]: exact-score accumulation, static argmin eviction,
                 attends to ALL cached tokens (no dynamic top-k).
  snapkv       — SnapKV [8]-style: prefill selection from an observation
                 window; decode behaves like h2o.
  unicaim      — the paper: quantized approx scoring + top-k + static evict.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs.base import PruneConfig


def dense(max_seq: int) -> PruneConfig:
    return PruneConfig(policy="dense", heavy_budget=max_seq, reserve=0,
                       sink_tokens=0, recent_window=1, select_k=1)


def streaming(budget: int, sinks: int = 4) -> PruneConfig:
    return PruneConfig(policy="streaming", heavy_budget=budget, reserve=0,
                       sink_tokens=sinks, recent_window=1, select_k=1)


def h2o(heavy: int, reserve: int, recent: int = 32) -> PruneConfig:
    return PruneConfig(policy="h2o", heavy_budget=heavy, reserve=reserve,
                       recent_window=recent, select_k=1, accumulate="exact")


def snapkv(heavy: int, reserve: int, obs_window: int = 32,
           recent: int = 32) -> PruneConfig:
    return PruneConfig(policy="h2o", heavy_budget=heavy, reserve=reserve,
                       recent_window=recent, select_k=1, accumulate="exact",
                       prefill_obs_window=obs_window)


def unicaim(heavy: int, reserve: int, select_k: int, score_bits: int = 3,
            query_bits: int = 4, **kw) -> PruneConfig:
    return PruneConfig(policy="unicaim", heavy_budget=heavy, reserve=reserve,
                       select_k=select_k, score_bits=score_bits,
                       query_bits=query_bits, **kw)


def with_budget(cfg: PruneConfig, heavy: int, reserve: int) -> PruneConfig:
    return dataclasses.replace(cfg, heavy_budget=heavy, reserve=reserve)
