"""Shared layers: RMS norm, RoPE, the SwiGLU MLP, and their inits — the
port of `repro/models/layers.py` (dense family).

Weights keep the reference layout: a projection is [d_in, d_out] and is
applied as `x @ W`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def dense_init(gen: torch.Generator, d_in: int, d_out: int, dtype,
               device, lead=()) -> torch.Tensor:
    """N(0, 1/d_in) weights [*lead, d_in, d_out], drawn in f32 on `device`
    one leading slice at a time and stored in `dtype`."""
    out = torch.empty(tuple(lead) + (d_in, d_out), dtype=dtype, device=device)
    flat = out.view(-1, d_in, d_out)
    for i in range(flat.shape[0]):
        w = torch.randn((d_in, d_out), generator=gen, dtype=torch.float32,
                        device=device)
        flat[i].copy_(w * (1.0 / math.sqrt(d_in)))
    return out


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, d), generator=gen, dtype=torch.float32,
                    device=device)
    return (w * 0.02).to(dtype)


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6):
    """RMS norm computed in f32 and cast back to x's dtype."""
    if kind != "rms":
        raise NotImplementedError(f"norm {kind!r} is not ported yet")
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["w"].float()).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """Rotary embedding over the last axis. Like the reference's code (not
    its docstring) it rotates the half-split pair x[..., :half] and
    x[..., half:]. x: [..., T, H, dh] with positions [..., T], or
    [B, H, dh] with positions [B, 1]."""
    dh = x.shape[-1]
    half = dh // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                         device=x.device) / half))
    ang = positions.float()[..., None] * freq                   # [..., half]
    while ang.dim() < x.dim():
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    if act != "swiglu":
        raise NotImplementedError(f"activation {act!r} is not ported yet")
    h = F.silu(x @ p["wg"]) * (x @ p["wi"])
    return h @ p["wo"]
