"""Learning-rate schedules, pure functions of the integer step — the port
of `repro/optim/schedule.py`. The step is an int or an integer tensor;
the result is an f32 scalar tensor on the step's device (the CPU for an
int), computed in f32 in the reference's order."""
from __future__ import annotations

import math

import torch


def _step_f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def warmup_cosine(step, peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> torch.Tensor:
    """Linear warmup to `peak_lr` over `warmup` steps (step 0 is never a
    no-op: it takes peak_lr / warmup), then a cosine decay to
    floor · peak_lr at `total`."""
    s = _step_f32(step)
    warm = peak_lr * (s + 1.0) / max(warmup, 1)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor + (1 - floor) * 0.5
                     * (1 + torch.cos(math.pi * prog)))
    return torch.where(s < warmup, warm, cos)


def constant(step, lr: float) -> torch.Tensor:
    return torch.full_like(_step_f32(step), lr)
