"""Gradient compression with error feedback — the port of the
error-feedback half of `repro/optim/compression.py`: gradients quantized
to int8 codes with per-row f32 scales (absmax / 127, floor 1e-20), the
quantization residual kept and added to the next step's gradients
(Karimireddy et al. 2019). The reduction that carries the codes,
`compressed_psum`, is a collective and waits for the multi-GPU slice
(ROADMAP.md Queue A item 11)."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.tree import tree_map


class ErrorFeedback(NamedTuple):
    residual: Any            # a tree like the gradients, f32


def init_error_feedback(grads_like) -> ErrorFeedback:
    return ErrorFeedback(residual=tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32,
                              device=g.device), grads_like))


def quantize_grad(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float()
    amax = gf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp(amax / 127.0, min=1e-20)
    return torch.round(gf / scale).to(torch.int8), scale


def dequantize_grad(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_with_feedback(grads, ef: ErrorFeedback):
    """Quantize grads + residual → ((codes, scales), the new feedback),
    codes and scales trees like the gradients."""
    def one(g, r):
        gf = g.float() + r
        q, s = quantize_grad(gf)
        return q, s, gf - dequantize_grad(q, s)

    out = tree_map(one, grads, ef.residual)
    return ((_select(out, 0), _select(out, 1)),
            ErrorFeedback(residual=_select(out, 2)))


def _select(tree, i):
    """Element i of each (code, scale, residual) triple of `tree`."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_select(v, i) for v in tree]
    return tree[i]
