"""Plain PyTorch versions of the Hopper kernels (the correctness contract).

Each function here is the port of the matching oracle in the reference's
`kernels/ref.py`. The CPU path runs it, and `chip_smoke.py` holds the
kernel against it on the card. The other oracles arrive with their kernels.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30
PROT_WIN = 1e30


def fused_decode_ref(q, qq, qscale, mirror, mscale, kscale, vscale, valid,
                     prot, k, v, *, select_k: int):
    """Fused pruned decode with global selection (`num_blocks == 1`): the
    plain version of `kernels/ragged_decode.py`.

      q [BH,G,d] float; qq [BH,G,d] int8; qscale [BH,G] f32;
      mirror [BH,S,d] int8; mscale, kscale, vscale [BH,S] f32;
      valid, prot [BH,S] int8; k [BH,S,d], v [BH,S,dv] float or int8
      → (out [BH,G,dv] f32, probs [BH,S] f32)

    Scores the int8 mirror, sums them over the G rows (protected slots win),
    takes the global top-k (ties to the lower slot), gathers only the
    winners' K/V rows times kscale/vscale, and runs exact softmax attention
    over them. probs[s] = Σ_g softmax_g(score/√d), exactly 0 at invalid
    slots. Slots at or past a row's fill are invalid, so the kernel's
    skipping of dead blocks and this path's masking agree."""
    bh, g, d = q.shape
    s = mirror.shape[1]
    assert select_k <= s, (select_k, s)
    scale = 1.0 / math.sqrt(d)

    # the integer contraction is exact in f32 (see core/scoring.py)
    raw = torch.matmul(qq.float(), mirror.float().transpose(1, 2))
    raw = raw * qscale.float()[..., None] * mscale.float()[:, None, :]
    raw = torch.where(valid[:, None, :] != 0, raw,
                      torch.full_like(raw, NEG_INF))            # [BH,G,S]

    # G-row sum in row order, as the kernel adds it, so both race on the
    # same values bit for bit
    ssel = raw[:, 0]
    for gi in range(1, g):
        ssel = ssel + raw[:, gi]
    ssel = torch.where(prot != 0, torch.full_like(ssel, PROT_WIN), ssel)
    _, idx = torch.sort(ssel, dim=-1, descending=True, stable=True)
    idx = idx[:, :select_k]                                     # [BH,K]

    def rows(x, sc):
        y = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        return y.float() * torch.gather(sc.float(), 1, idx)[..., None]

    k_sel, v_sel = rows(k, kscale), rows(v, vscale)
    valid_sel = torch.gather(valid, 1, idx)                     # [BH,K]
    logits = torch.matmul(q.float(), k_sel.transpose(1, 2)) * scale
    logits = torch.where(valid_sel[:, None, :] != 0, logits,
                         torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=-1, keepdim=True)
    e = torch.exp(logits - m) * (logits > NEG_INF / 2)
    z = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    out = torch.matmul(e / z, v_sel)

    lg = raw * scale
    eg = torch.exp(lg - lg.amax(dim=-1, keepdim=True)) * (raw > NEG_INF / 2)
    zg = torch.clamp(eg.sum(dim=-1, keepdim=True), min=1e-30)
    probs = (eg / zg).sum(dim=1)                                # [BH,S]
    return out, probs
