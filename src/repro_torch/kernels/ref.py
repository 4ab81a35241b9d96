"""Plain PyTorch versions of the Hopper kernels (the correctness contract).

Each function here is the port of the matching oracle in the reference's
`kernels/ref.py`. The CPU path runs it, and `chip_smoke.py` holds the
kernel against it on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quant import unpack_int4

NEG_INF = -1e30
PROT_WIN = 1e30


def approx_score_ref(qq, qscale, kq, kscale, valid):
    """CAM-mode scores, the plain version of `kernels/approx_score.py`:
    qq [BH,G,d] int8, qscale [BH,G], kq [BH,S,d] int8, kscale [BH,S],
    valid [BH,S] → [BH,G,S] f32 = (qq·kq)·qscale·kscale, NEG_INF at invalid
    slots. The integer contraction is exact in f32 (|Σ| <= 127·127·128 <
    2^24), so this equals the reference's int32 one bit for bit."""
    raw = torch.matmul(qq.float(), kq.float().transpose(1, 2))
    sc = raw * qscale.float()[..., None] * kscale.float()[:, None, :]
    return torch.where(valid[:, None, :] != 0, sc, torch.full_like(sc, NEG_INF))


def approx_score_packed_ref(qq, qscale, kq_packed, kscale, valid):
    """The same scores over an int4 mirror packed two codes to a byte
    (kq_packed [BH,S,d/2] uint8): unpack, then score."""
    return approx_score_ref(qq, qscale, unpack_int4(kq_packed), kscale, valid)


def gather_attention_ref(q, k, v, valid):
    """Exact softmax attention over K gathered rows, the plain version of
    `kernels/gather_attention.py`: q [BH,G,d], k [BH,K,d], v [BH,K,dv],
    valid [BH,K] → [BH,G,dv] f32. Invalid rows get logit NEG_INF; a row
    with no valid slot therefore averages its K value rows (softmax over
    equal logits), as the reference's oracle does."""
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) / math.sqrt(
        q.shape[-1])
    s = torch.where(valid[:, None, :] != 0, s, torch.full_like(s, NEG_INF))
    return torch.matmul(torch.softmax(s, dim=-1), v.float())


def fused_decode_ref(q, qq, qscale, mirror, mscale, kscale, vscale, valid,
                     prot, k, v, *, select_k: int, num_blocks: int = 1):
    """Fused pruned decode: the plain version of `kernels/fused_decode.py`
    and (with `num_blocks == 1`) of `kernels/ragged_decode.py`.

      q [BH,G,d] float; qq [BH,G,d] int8; qscale [BH,G] f32;
      mirror [BH,S,d] int8; mscale, kscale, vscale [BH,S] f32;
      valid, prot [BH,S] int8; k [BH,S,d], v [BH,S,dv] float or int8
      → (out [BH,G,dv] f32, probs [BH,S] f32)

    Scores the int8 mirror, sums them over the G rows (protected slots
    win), and races each of the `num_blocks` equal slot blocks for
    select_k / num_blocks winners (ties to the lower slot); gathers only
    the winners' K/V rows times kscale/vscale and runs one exact softmax
    attention over all of them. probs[s] = Σ_g softmax_g(score/√d),
    exactly 0 at invalid slots. Slots at or past a row's fill are invalid,
    so the ragged kernel's skipping of dead blocks and this path's masking
    agree."""
    bh, g, d = q.shape
    s = mirror.shape[1]
    nb = num_blocks
    assert s % nb == 0 and select_k % nb == 0, (s, select_k, nb)
    k_loc, bs = select_k // nb, s // nb
    assert k_loc <= bs, (k_loc, bs)
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
    _, idx = torch.sort(ssel.reshape(bh, nb, bs), dim=-1, descending=True,
                        stable=True)
    idx = (idx[..., :k_loc] + torch.arange(0, s, bs, device=idx.device)[
        :, None]).reshape(bh, select_k)                         # [BH,K]

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
