"""Signed multibit quantization — the port of `repro/core/quant.py`.

    q  = round(clip(x / s, -qmax, qmax)),   s = max|x| / qmax

stored in an int8 container (optionally packed two codes to a byte for
4-bit), with a per-row f32 scale; 1-bit degenerates to sign(x) with
s = mean|x|. The codes must equal the reference's exactly (a
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


# ---------------------------------------------------------------------------
# int4 packing: two 4-bit codes per byte, the even index in the low nibble
# (the layout `kernels/approx_score.approx_score_packed` reads).
# ---------------------------------------------------------------------------


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """Pack int8 codes in [-8, 7] along the last axis (must be even) into
    uint8 bytes."""
    assert q.shape[-1] % 2 == 0, "pack_int4 needs an even last axis"
    lo = q[..., 0::2].to(torch.uint8) & 0xF
    hi = (q[..., 1::2].to(torch.uint8) & 0xF) << 4
    return lo | hi


def unpack_int4(p: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4 → int8 codes, nibbles >= 8 sign-extended
    (code - 16)."""
    lo = (p & 0xF).to(torch.int8)
    hi = ((p >> 4) & 0xF).to(torch.int8)
    lo = torch.where(lo >= 8, lo - 16, lo)
    hi = torch.where(hi >= 8, hi - 16, hi)
    return torch.stack([lo, hi], dim=-1).reshape(*p.shape[:-1],
                                                 p.shape[-1] * 2)


def mirror_bytes_per_token(head_dim: int, bits: int) -> int:
    """Device-memory bytes of the quantized key mirror per (token, kv-head)
    at the packing density of production (1-bit: 8 a byte, 2-bit: 4 a
    byte, 3-4 bit: nibble-packed, 5-8 bit: int8), plus 4 for the f32
    scale."""
    if bits == 1:
        return -(-head_dim // 8) + 4
    if bits == 2:
        return -(-head_dim // 4) + 4
    if bits <= 4:
        return head_dim // 2 + 4
    return head_dim + 4


def quantize_packed(x: torch.Tensor, bits: int):
    """quantize, then pack_int4 when bits <= 4."""
    q, s = quantize(x, bits)
    if bits <= 4:
        return pack_int4(q), s
    return q, s
