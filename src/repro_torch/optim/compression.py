"""Gradient compression with error feedback — the port of
`repro/optim/compression.py`: gradients quantized to int8 codes with
per-row f32 scales (absmax / 127, floor 1e-20), the quantization residual
kept and added to the next step's gradients (Karimireddy et al. 2019), and
`compressed_psum`, the data-parallel mean whose wire payload is the int8
codes and their f32 scales."""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.runtime import sharding
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


def gather_quantized(x: torch.Tensor, group
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`quantize_grad(x)` on every rank of `group`, all-gathered →
    (codes [n, ...] int8, scales [n, ..., 1] f32) in rank order."""
    q, s = quantize_grad(x)
    return sharding.all_gather(q, group), sharding.all_gather(s, group)


def compressed_psum(x: torch.Tensor, mesh, axis: str = "data"
                    ) -> torch.Tensor:
    """All-reduce-mean of x over the process mesh's `axis` with an int8
    payload: "quantize → all-gather int8 codes and f32 row scales → local
    sum", the reference's order (the dequantized pieces summed over the
    rank axis, then divided by n). x is identically shaped on every
    rank."""
    mesh = sharding.as_mesh(mesh)
    n = mesh.shape[axis]
    qg, sg = gather_quantized(x, mesh.group(axis))
    return (qg.float() * sg).sum(dim=0) / n


def _select(tree, i):
    """Element i of each (code, scale, residual) triple of `tree`."""
    if isinstance(tree, dict):
        return {k: _select(v, i) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_select(v, i) for v in tree]
    return tree[i]
