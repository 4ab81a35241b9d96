"""Fault tolerance for training: the checkpoint / restart step loop and
the straggler watchdog — the port of `repro/runtime/fault.py`.

The control flow is the reference's: a step that raises TimeoutError,
RuntimeError or ValueError (or an injected failure, `inject_failure`)
restores the latest checkpoint and replays from its step (the data is a
function of the step index), up to `max_restarts`; a per-step deadline
counts stragglers and may raise; checkpoints every `ckpt_every` steps and
one blocking save at the end. Where the reference blocks on the metrics,
this loop synchronises the state's card (nothing on the CPU).
`elastic_restore` restores the latest checkpoint onto the current mesh.
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from repro_torch.checkpoint.manager import CheckpointManager, spec_like
from repro_torch.tree import leaves

log = logging.getLogger("repro_torch.fault")


@dataclass
class FaultConfig:
    ckpt_every: int = 50
    max_restarts: int = 3
    step_deadline_s: float = 0.0      # 0 = disabled
    straggler_action: str = "log"     # 'log' | 'raise'


@dataclass
class LoopStats:
    steps: int = 0
    restarts: int = 0
    straggler_events: int = 0
    losses: list = field(default_factory=list)


def _sync(state) -> None:
    """Wait for the card that holds the state's first leaf (no-op on the
    CPU)."""
    first = leaves(state)[:1]
    if first and first[0].device.type == "cuda":
        torch.cuda.synchronize(first[0].device)


def run_training(step_fn: Callable, state: Any, data_iter, num_steps: int,
                 ckpt: CheckpointManager, fcfg: FaultConfig,
                 start_step: int = 0,
                 inject_failure: Optional[Callable[[int], None]] = None,
                 on_metrics: Optional[Callable] = None) -> tuple:
    """Fault-tolerant training loop.

    step_fn: (state, batch) → (state, metrics), a function of its inputs.
    data_iter: step → batch. Returns (state, LoopStats); the losses are
    recorded where `on_metrics` is given, as in the reference."""
    stats = LoopStats()
    step = start_step
    restarts = 0
    state_template = spec_like(state)

    while step < num_steps:
        try:
            batch = data_iter(step)
            t0 = time.monotonic()
            if inject_failure is not None:
                inject_failure(step)
            state, metrics = step_fn(state, batch)
            if on_metrics is not None:
                _sync(state)
                on_metrics(step, metrics)
                if isinstance(metrics, dict) and "loss" in metrics:
                    stats.losses.append(float(metrics["loss"]))
            dt = time.monotonic() - t0
            if fcfg.step_deadline_s and dt > fcfg.step_deadline_s:
                stats.straggler_events += 1
                log.warning("straggler: step %d took %.3fs (deadline %.3fs)",
                            step, dt, fcfg.step_deadline_s)
                if fcfg.straggler_action == "raise":
                    raise TimeoutError(f"step {step} exceeded deadline")
            step += 1
            stats.steps += 1
            if step % fcfg.ckpt_every == 0:
                ckpt.save(step, state)
        except (TimeoutError, RuntimeError, ValueError) as e:
            restarts += 1
            stats.restarts = restarts
            if restarts > fcfg.max_restarts:
                raise RuntimeError(
                    f"exceeded {fcfg.max_restarts} restarts") from e
            log.warning("step %d failed (%s); restoring latest checkpoint",
                        step, e)
            ckpt.wait()
            latest = ckpt.latest_step()
            if latest is not None:
                state = ckpt.restore(latest, state_template)
                step = latest
            else:
                step = start_step
    ckpt.save(step, state, block=True)
    return state, stats


def elastic_restore(ckpt: CheckpointManager, state_template: Any,
                    make_shardings: Callable[[], Any]) -> Any:
    """Restore the latest checkpoint onto the CURRENT mesh topology.

    `make_shardings()` recomputes the layout from the logical rules under
    the active mesh (`runtime.sharding.params_shardings`): a tree like the
    template of `NamedSharding`s, so the same checkpoint restores onto any
    mesh. Returns a tree of DTensors, each rank holding its shard."""
    return ckpt.restore_latest(state_template, make_shardings())
