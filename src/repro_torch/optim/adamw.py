"""AdamW with optional int8 moments — the port of `repro/optim/adamw.py`.

The quantized moments (`QTensor`: int8 codes and an f32 scale per row of
the last axis, absmax / 127 with a floor of 1e-12) take about 2.06 bytes a
parameter for (m, v) where f32 takes 8. The state mirrors the parameter
tree: `m` and `v` hold an f32 tensor or a `QTensor` where the parameters
hold a tensor.

`update` does its arithmetic in f32 in the reference's order (the clip by
the global norm, the bias corrections, the decoupled weight decay) and
casts to each parameter's dtype. It writes the parameters and the moments
IN PLACE, one leaf at a time under `torch.no_grad()` (so a full-size
model's state is not held twice), and returns them: the values are the
reference's pure update's.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from repro_torch.tree import leaves, tree_map


class QTensor(NamedTuple):
    q: torch.Tensor          # int8 codes
    scale: torch.Tensor      # f32 per-row scale [..., 1]


def _q8(x: torch.Tensor) -> QTensor:
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-12)
    return QTensor(torch.round(xf / scale).to(torch.int8), scale)


def _dq8(t: QTensor) -> torch.Tensor:
    return t.q.float() * t.scale


class AdamWState(NamedTuple):
    step: torch.Tensor       # int32 scalar
    m: Any                   # the parameter tree, f32 tensors or QTensors
    v: Any


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    quantized_state: bool = False


def init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments shaped like `params` on their devices (int8 ones with
    `quantized_state`), and step 0."""
    def zero(p):
        z = torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        return _q8(z) if cfg.quantized_state and p.dim() >= 1 else z
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zero, params), v=tree_map(zero, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over the leaves of their f32 sums of squares, added
    leaf by leaf in tree order."""
    total = 0
    for x in leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(torch.as_tensor(total))


def moment_leaves(tree) -> list:
    """The moments in tree order, an int8 moment's QTensor as one leaf."""
    return leaves(tree, is_leaf=lambda t: isinstance(t, QTensor))


@torch.no_grad()
def update(grads, state: AdamWState, params, cfg: AdamWConfig,
           lr: Optional[torch.Tensor] = None) -> Tuple[Any, AdamWState]:
    """One AdamW step over the parameter tree → (params, state), both
    written in place (see the module note). `grads` mirrors `params`; `lr`
    (an f32 scalar tensor, e.g. from a schedule) overrides `cfg.lr`."""
    lr = cfg.lr if lr is None else lr
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                       max=1.0)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=step.device), step.float())
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=step.device), step.float())

    def upd(p, g, m, v):
        gf = g.float() * clip
        mf = _dq8(m) if isinstance(m, QTensor) else m
        vf = _dq8(v) if isinstance(v, QTensor) else v
        mf = cfg.b1 * mf + (1 - cfg.b1) * gf
        vf = cfg.b2 * vf + (1 - cfg.b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        pf = p.float()
        pn = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * pf)
        p.copy_(pn)
        for old, new in ((m, mf), (v, vf)):
            if isinstance(old, QTensor):
                qt = _q8(new)
                old.q.copy_(qt.q)
                old.scale.copy_(qt.scale)
            else:
                old.copy_(new)

    p_l = leaves(params)
    g_l = leaves(grads)
    m_l = moment_leaves(state.m)
    v_l = moment_leaves(state.v)
    for p, g, m, v in zip(p_l, g_l, m_l, v_l, strict=True):
        upd(p, g, m, v)
    state.step.copy_(step)
    return params, state

