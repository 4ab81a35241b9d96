"""Mamba2's state-space-duality (SSD) block — the port of
`repro/models/ssm.py`. [arXiv:2405.21060]

The prompt pass is the chunked SSD: attention-like within a chunk, a linear
recurrence across chunks. Decode is the O(1) recurrence on the [B, H, P, N]
state. The reference's block is plain XLA (no Pallas kernel), so this one
is plain PyTorch: its einsums are `torch.einsum` and its chunk scan a loop.
UniCAIM pruning does not apply here (there is no KV cache).

Parity with the reference rests on its order and dtypes: the causal conv
is a sum of K shifted products in the compute dtype, in tap order; the SSD
runs in f32 with every prompt-pass `exp` clipped to [-60, 0]; the decode
decay is not clipped; the output `y + D·x` goes back to x's dtype before
the gated norm.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.layers import dense_init, rms_norm_gated


@dataclass
class SSMState:
    conv: torch.Tensor               # [B, K-1, conv_channels] f32: the
    #                                  rolling conv window
    ssm: torch.Tensor                # [B, H, P, N] f32 recurrent state

    def map(self, fn) -> "SSMState":
        return SSMState(fn(self.conv), fn(self.ssm))

    def layer(self, li: int) -> "SSMState":
        """Views of layer `li` of a layer-stacked state: writes through them
        land in the stacked buffers."""
        return self.map(lambda a: a[li])

    def clone(self) -> "SSMState":
        return self.map(torch.clone)


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    n_heads = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return d_in, n_heads, conv_ch


def init_ssm(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             lead=()):
    """One block's weights (stacked on `lead`), with the reference's
    distributions: N(0, 1/d_in) projections, conv taps N(0, 1)·0.1, zero
    conv bias, A_log and dt_bias, unit D and gate-norm weight; A_log, D and
    dt_bias in f32 whatever `dtype` is."""
    s = cfg.ssm
    d_in, n_heads, conv_ch = _dims(cfg)
    lead = tuple(lead)

    def full(width, value, dt):
        return torch.full(lead + (width,), value, dtype=dt, device=device)

    conv_w = torch.randn(lead + (s.conv_kernel, conv_ch), generator=gen,
                         dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(gen, cfg.d_model,
                              2 * d_in + 2 * s.n_groups * s.d_state + n_heads,
                              dtype, device, lead),
        "conv_w": (conv_w * 0.1).to(dtype),
        "conv_b": full(conv_ch, 0.0, dtype),
        "A_log": full(n_heads, 0.0, torch.float32),
        "D": full(n_heads, 1.0, torch.float32),
        "dt_bias": full(n_heads, 0.0, torch.float32),
        "norm_w": full(d_in, 1.0, dtype),
        "out_proj": dense_init(gen, d_in, cfg.d_model, dtype, device, lead),
    }


def init_ssm_state(cfg: ModelConfig, batch: int, device="cpu",
                   layers: Optional[int] = None) -> SSMState:
    """An empty f32 state; `layers` adds a leading layer axis."""
    s = cfg.ssm
    d_in, n_heads, conv_ch = _dims(cfg)
    lead = () if layers is None else (layers,)
    return SSMState(
        conv=torch.zeros(lead + (batch, s.conv_kernel - 1, conv_ch),
                         dtype=torch.float32, device=device),
        ssm=torch.zeros(lead + (batch, n_heads, s.head_dim, s.d_state),
                        dtype=torch.float32, device=device))


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 prior: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. xbc: [B, T, C], w: [K, C]; `prior`
    [B, K-1, C] is the window before xbc (zeros when None). The sum of the
    K shifted products runs in xbc's dtype, in tap order, as the
    reference's Python `sum` does → (silu(conv + b), the last K-1 rows of
    the padded input, in xbc's dtype)."""
    k = w.shape[0]
    if prior is None:
        pad = torch.zeros((xbc.shape[0], k - 1, xbc.shape[2]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = prior.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=1)                       # [B, T+K-1, C]
    t = xbc.shape[1]
    out = 0
    for i in range(k):
        out = out + xp[:, i:i + t] * w[i]
    new_prior = xp[:, t:] if k > 1 else None
    return F.silu(out + b), new_prior


def _split(p, x: torch.Tensor, cfg: ModelConfig):
    """x @ in_proj → (z, xBC, dt)."""
    s = cfg.ssm
    d_in, n_heads, _ = _dims(cfg)
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * s.n_groups * s.d_state]
    dt = zxbcdt[..., -n_heads:]
    return z, xbc, dt


def _heads(xbc: torch.Tensor, cfg: ModelConfig):
    """xBC [..., conv_ch] → (x [..., H, P], B [..., H, N], C [..., H, N]),
    B and C repeated from their groups over the heads."""
    s = cfg.ssm
    d_in, n_heads, _ = _dims(cfg)
    lead = xbc.shape[:-1]
    gn = s.n_groups * s.d_state
    xs = xbc[..., :d_in].reshape(*lead, n_heads, s.head_dim)
    b_mat = xbc[..., d_in:d_in + gn].reshape(*lead, s.n_groups, s.d_state)
    c_mat = xbc[..., d_in + gn:].reshape(*lead, s.n_groups, s.d_state)
    rep = n_heads // s.n_groups
    return (xs, torch.repeat_interleave(b_mat, rep, dim=-2),
            torch.repeat_interleave(c_mat, rep, dim=-2))


def _clipped_exp(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(torch.clamp(x, -60.0, 0.0))


def ssd_chunked(xs: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                b_mat: torch.Tensor, c_mat: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None):
    """Chunked SSD scan, all in f32.

    xs: [B, T, H, P]; dt: [B, T, H] (after softplus); A: [H] (negative);
    b_mat / c_mat: [B, T, H, N]. Time is zero-padded to a multiple of
    q = min(chunk, T): a pad has x = B = 0 and dt = 0 (decay 1), so it
    leaves the state alone, and its outputs are sliced off. Returns
    (y [B, T, H, P], final state [B, H, P, N])."""
    bsz, t, h, p_dim = xs.shape
    n = b_mat.shape[-1]
    q = min(chunk, t)
    t_real = t
    pad = (-t) % q
    if pad:
        xs = F.pad(xs, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        b_mat = F.pad(b_mat, (0, 0, 0, 0, 0, pad))
        c_mat = F.pad(c_mat, (0, 0, 0, 0, 0, pad))
        t = t + pad
    nc = t // q
    xs = xs.reshape(bsz, nc, q, h, p_dim).float()
    dt = dt.reshape(bsz, nc, q, h).float()
    bm = b_mat.reshape(bsz, nc, q, h, n).float()
    cm = c_mat.reshape(bsz, nc, q, h, n).float()

    cum = torch.cumsum(dt * A, dim=2)                         # [B, c, Q, H]
    # the diagonal (intra-chunk) term: attention-like with a decay kernel
    seg = _clipped_exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    causal = torch.ones((q, q), dtype=torch.bool, device=xs.device).tril()
    seg = torch.where(causal[None, None, :, :, None], seg, 0.0)
    cb = torch.einsum("bcihn,bcjhn->bcijh", cm, bm)
    w = cb * seg * dt[:, :, None, :, :]                       # [B, c, i, j, H]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", w, xs)

    # each chunk's state: decay from j to the chunk's end
    decay_end = _clipped_exp(cum[:, :, -1:, :] - cum)
    states = torch.einsum("bcjhn,bcjhp->bchpn",
                          (dt * decay_end)[..., None] * bm, xs)
    chunk_decay = _clipped_exp(cum[:, :, -1, :])              # [B, c, H]

    # the scan across chunks keeps the state BEFORE each chunk
    s_run = (torch.zeros((bsz, h, p_dim, n), dtype=torch.float32,
                         device=xs.device)
             if initial_state is None else initial_state.float())
    prev = []
    for c in range(nc):
        prev.append(s_run)
        s_run = s_run * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                    # [B, c, H, P, N]

    # the off-diagonal term: the previous state, decayed to position i
    in_decay = _clipped_exp(cum)                              # [B, c, Q, H]
    y_off = torch.einsum("bcihn,bchpn->bcihp", cm * in_decay[..., None],
                         prev_states)
    y = (y_diag + y_off).reshape(bsz, t, h, p_dim)
    return y[:, :t_real], s_run


def ssm_train(p, x: torch.Tensor, cfg: ModelConfig,
              state: Optional[SSMState] = None, return_state: bool = False):
    """The block over a whole sequence (the prompt pass). x: [B, T, d] →
    [B, T, d]; with `return_state`, also the SSMState after it (the conv
    window in x's dtype, the SSM state in f32). `state` seeds the conv
    window and the scan."""
    s = cfg.ssm
    d_in, _, _ = _dims(cfg)
    b, t, _ = x.shape
    z, xbc, dt = _split(p, x, cfg)
    prior = state.conv if state is not None else None
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], prior)
    xs, b_mat, c_mat = _heads(xbc, cfg)
    dt = F.softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    init = state.ssm if state is not None else None
    y, final = ssd_chunked(xs, dt, A, b_mat, c_mat, s.chunk_size, init)
    y = y + p["D"][:, None] * xs.float()
    y = y.reshape(b, t, d_in).to(x.dtype)
    y = rms_norm_gated(y, z, p["norm_w"])
    out = y @ p["out_proj"]
    if return_state:
        return out, SSMState(conv=new_conv, ssm=final)
    return out


def ssm_decode(p, x: torch.Tensor, cfg: ModelConfig, state: SSMState,
               active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step, x: [B, d] → y [B, d], writing `state` (views of one
    layer of the stacked state) in place. `active` ([B] bool, optional)
    freezes the other lanes' state bit for bit, as the reference's
    `lane_select` does."""
    d_in, _, _ = _dims(cfg)
    b, _ = x.shape
    z, xbc, dt = _split(p, x[:, None, :], cfg)
    xbc, new_conv = _causal_conv(xbc, p["conv_w"], p["conv_b"], state.conv)
    xs, b_mat, c_mat = _heads(xbc[:, 0], cfg)                # [B,H,P],[B,H,N]
    dt = F.softplus(dt[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    decay = torch.exp(dt * A)                                # [B, H]
    xf = xs.float()
    upd = (dt[..., None, None] * xf[..., :, None]
           * b_mat.float()[..., None, :])                    # [B, H, P, N]
    ssm = state.ssm * decay[..., None, None] + upd
    y = torch.einsum("bhn,bhpn->bhp", c_mat.float(), ssm)
    y = y + p["D"][:, None] * xf
    y = y.reshape(b, d_in).to(x.dtype)
    y = rms_norm_gated(y, z[:, 0], p["norm_w"])
    _write(state, SSMState(conv=new_conv, ssm=ssm), active)
    return y @ p["out_proj"]


def _write(state: SSMState, new: SSMState,
           active: Optional[torch.Tensor]) -> None:
    """In place: `state` takes `new` on the active lanes (all without
    `active`)."""
    for dst, src in ((state.conv, new.conv), (state.ssm, new.ssm)):
        src = src.to(dst.dtype)
        if active is not None:
            src = torch.where(active.reshape((-1,) + (1,) * (src.dim() - 1)),
                              src, dst)
        dst.copy_(src)


def ssm_prefill(p, x: torch.Tensor, cfg: ModelConfig,
                state: SSMState) -> torch.Tensor:
    """The prompt pass from an empty state, writing the state it ends in
    into `state` (views of one layer of the stacked state) → y [B, T, d]."""
    y, st = ssm_train(p, x, cfg, return_state=True)
    _write(state, st, None)
    return y
