"""Signed multibit quantization — the port of `repro/core/quant.py`.

    q  = round(clip(x / s, -qmax, qmax)),   s = max|x| / qmax

stored in an int8 container, with a per-row f32 scale; 1-bit degenerates to
sign(x) with s = mean|x|. The codes must equal the reference's exactly (a
code that moves by 1 changes the top-k sets later on), so this follows the
reference operation by operation: `torch.round` rounds half to even like
`jnp.round`, and the division is by `safe`, never a multiply by its
reciprocal.
"""
from __future__ import annotations

import torch


def qmax_for_bits(bits: int) -> int:
    """Largest representable magnitude for `bits`-bit signed symmetric."""
    if bits == 1:
        return 1
    return 2 ** (bits - 1) - 1


def quantize(x: torch.Tensor, bits: int):
    """Quantize along the last axis → (q int8 of x.shape, scale f32 of
    x.shape[:-1])."""
    xf = x.float()
    if bits == 1:
        scale = xf.abs().mean(dim=-1)
        q = torch.where(xf >= 0, 1, -1).to(torch.int8)
        return q, scale
    qm = qmax_for_bits(bits)
    scale = xf.abs().amax(dim=-1) / qm
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    q = torch.clamp(torch.round(xf / safe[..., None]), -qm, qm)
    return q.to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def quantize_query(x: torch.Tensor, bits: int):
    """Query-side 'bitwise expansion' (paper Fig. 6c): numerically the same
    symmetric mapping as the keys."""
    return quantize(x, bits)
