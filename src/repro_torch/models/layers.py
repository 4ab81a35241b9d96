"""Shared layers: RMS norm and LayerNorm, Mamba2's gated RMS norm, RoPE,
sinusoidal positions, the MLP (SwiGLU, tanh-GELU or relu²), and their
inits — the port of `repro/models/layers.py`.

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
    one leading slice at a time and stored in `dtype` (on `meta`, where a
    draw makes nothing, the shape alone)."""
    out = torch.empty(tuple(lead) + (d_in, d_out), dtype=dtype, device=device)
    if out.is_meta:
        return out
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


def norm_init(kind: str, d: int, dtype, device, lead=()):
    """Unit weights, and zero biases for LayerNorm (`kind="ln"`)."""
    shape = tuple(lead) + (d,)
    p = {"w": torch.ones(shape, dtype=dtype, device=device)}
    if kind != "rms":
        p["b"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6):
    """RMS norm (`kind="rms"`) or LayerNorm (population variance), computed
    in f32 and cast back to x's dtype."""
    xf = x.float()
    if kind == "rms":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps)
        return (y * p["w"].float()).to(x.dtype)
    xc = xf - xf.mean(dim=-1, keepdim=True)
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * p["w"].float() + p["b"].float()).to(x.dtype)


def rms_norm_gated(x: torch.Tensor, z: torch.Tensor, w: torch.Tensor,
                   eps: float = 1e-6) -> torch.Tensor:
    """Mamba2's gated RMS norm, norm(x * silu(z)) * w: the gate product in
    x's dtype, the norm in f32, cast back to x's dtype."""
    xf = (x * F.silu(z)).float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


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


def sinusoidal(positions: torch.Tensor, d: int) -> torch.Tensor:
    """The sinusoidal position table [..., d] f32 at integer `positions`:
    [sin, cos] of pos · 10000^(-i/half), the frequencies computed as the
    reference computes them (f32 power, then its reciprocal)."""
    half = d // 2
    freq = 1.0 / (10000.0 ** (torch.arange(half, dtype=torch.float32,
                                           device=positions.device) / half))
    ang = positions.float()[..., None] * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def mlp_init(gen: torch.Generator, d: int, d_ff: int, act: str, dtype,
             device, lead=()):
    """wi, wg (SwiGLU only) and wo, drawn in that order."""
    p = {"wi": dense_init(gen, d, d_ff, dtype, device, lead)}
    if act == "swiglu":
        p["wg"] = dense_init(gen, d, d_ff, dtype, device, lead)
    p["wo"] = dense_init(gen, d_ff, d, dtype, device, lead)
    return p


def activate(act: str, h: torch.Tensor, gate=None) -> torch.Tensor:
    """The MLP's nonlinearity on h = x @ wi: SwiGLU (silu(gate) * h, with
    gate = x @ wg), GELU in its tanh form (`jax.nn.gelu`'s default, not
    the erf form) or relu²."""
    if act == "swiglu":
        return F.silu(gate) * h
    if act == "gelu":
        return F.gelu(h, approximate="tanh")
    if act == "relu2":
        return torch.square(F.relu(h))
    raise ValueError(act)


def apply_mlp(p, x: torch.Tensor, act: str) -> torch.Tensor:
    gate = x @ p["wg"] if act == "swiglu" else None
    return activate(act, x @ p["wi"], gate) @ p["wo"]
