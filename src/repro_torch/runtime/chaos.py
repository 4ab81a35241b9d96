"""Deterministic fault injection for the serving path — the port of
`repro/runtime/chaos.py` (numpy only, so the masks are bit-equal to the
reference's). A frozen `ChaosConfig` injects

  * **logit corruption** — a per-(block, step, lane) NaN mask, derived
    from `(seed, block_index)` alone, that the decode block applies on the
    device (`decode_block_lanes(fault=...)`). The poisoned lane trips the
    non-finite sentinel and exercises quarantine + retry;
  * **dispatch stalls** — a host-side sleep before chosen decode blocks
    (a slow interconnect or a preempted host), exercising deadline expiry
    without touching any numerics;
  * **queue floods** — a burst of synthetic `Request` kwargs, exercising
    bounded admission (`max_queue`) and the degradation ladder;
  * **shard blackouts** — a scheduler-round interval during which one
    shard's free lanes are hidden from admission (a brownout: resident
    lanes keep decoding, no new work lands on the shard; admission routes
    around it to the other shards of a lane-sharded `ServeLoop`).

Everything is a pure function of (seed, block index / round index), so
every recovery path is replayable bit for bit: the same config injects the
same faults into the same dispatch sequence, and the engine's recovered
token streams can be asserted token-identical to a clean run
(`tests/test_torch_chaos_serve.py`, `chip_smoke.py` phase 8).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """One deterministic fault-injection plan.

    `logit_fault_rate` is the per-(step, lane) corruption probability
    inside each targeted decode block; `fault_blocks`/`fault_lanes`
    restrict which block indices / lanes can be hit (None = all).
    `stall_blocks` sleep `stall_s` seconds before those decode blocks.
    `blackout_shard` hides that shard's free lanes from admission for
    scheduler rounds in `[blackout_rounds[0], blackout_rounds[1])`.
    """
    seed: int = 0
    logit_fault_rate: float = 0.0
    fault_blocks: Optional[Tuple[int, ...]] = None
    fault_lanes: Optional[Tuple[int, ...]] = None
    stall_blocks: Tuple[int, ...] = ()
    stall_s: float = 0.0
    blackout_shard: int = -1
    blackout_rounds: Tuple[int, int] = (0, 0)

    def fault_mask(self, block: int, steps: int, lanes: int) -> np.ndarray:
        """[steps, lanes] bool: which decode positions of block `block`
        get their logits poisoned. Derived from (seed, block) alone —
        independent of call order, so a replayed run injects identically."""
        mask = np.zeros((steps, lanes), bool)
        if self.logit_fault_rate <= 0.0:
            return mask
        if self.fault_blocks is not None and block not in self.fault_blocks:
            return mask
        rng = np.random.default_rng([self.seed, block])
        mask = rng.random((steps, lanes)) < self.logit_fault_rate
        if self.fault_lanes is not None:
            keep = np.zeros(lanes, bool)
            keep[list(self.fault_lanes)] = True
            mask &= keep[None, :]
        return mask

    def stall(self, block: int) -> float:
        """Seconds to sleep before decode block `block` (0 = none)."""
        return self.stall_s if block in self.stall_blocks else 0.0

    def blacked_out(self, round_: int, shard: int) -> bool:
        """Whether `shard` is admission-blacked-out at scheduler round
        `round_` (rounds advance once per `run()` iteration, so a
        blackout always expires even when nothing else makes progress)."""
        lo, hi = self.blackout_rounds
        return shard == self.blackout_shard and lo <= round_ < hi

    @property
    def any_faults(self) -> bool:
        """Whether this config can inject anything at all (an inert
        config lets the engine skip per-block mask construction)."""
        return (self.logit_fault_rate > 0.0 or bool(self.stall_blocks)
                or self.blackout_shard >= 0)


def flood(vocab: int, n: int, length: int = 16, max_new: int = 8,
          priority: int = 0, seed: int = 0, arrival: float = 0.0):
    """`n` synthetic same-shape request kwargs for a queue-flood burst —
    deterministic in `seed`, ready for `Request(**kw)`."""
    rng = np.random.default_rng(seed)
    return [dict(prompt=rng.integers(0, vocab, length), max_new=max_new,
                 priority=priority, arrival=arrival) for _ in range(n)]
