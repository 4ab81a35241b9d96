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


def flash_prefill_ref(q, k, v, group: int = 1, lengths=None):
    """Causal attention with per-q-head column sums, the plain version of
    `kernels/flash_prefill.py` (the TPU contract): q [BH,N,d], k/v
    [BH/group,N,d] → (out [BH,N,d] in q's dtype, acc [BH,N] f32).

    The probabilities stay in f32. `lengths` ([BH] int32, optional) are
    the true row counts of right-padded prompts: rows at or past them add
    no column mass (their output rows are not meaningful)."""
    bh, n, d = q.shape
    kx = torch.repeat_interleave(k, group, dim=0).float()
    vx = torch.repeat_interleave(v, group, dim=0).float()
    s = torch.matmul(q.float(), kx.transpose(1, 2)) / math.sqrt(d)
    mask = torch.tril(torch.ones((n, n), dtype=torch.bool, device=q.device))
    s = torch.where(mask[None], s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.matmul(p, vx)
    if lengths is not None:
        live = (torch.arange(n, device=q.device)[None, :]
                < lengths.to(torch.int32)[:, None])
        p = p * live[:, :, None]
    return out.to(q.dtype), p.sum(dim=1)


def prefill_attention_ref(q, k, v, *, row0: int = 0, length=None,
                          obs_window: int = 0, chunk: int = 512,
                          scale=None):
    """Causal prompt attention with kv-head column sums (the model's
    contract, `core/attention.py::chunked_causal_attention` and
    `prefill_chunk_attend` of the reference), one block of `chunk` query
    rows at a time.

    q [B,Hq,C,d] holds the queries of absolute rows [row0, row0+C); k/v
    [B,Hk,N,d] with N >= row0+C (columns past a row are causally masked,
    so unwritten buffer rows take no part). Returns (out [B,Hq,C,dv] f32,
    col_acc [B,Hk,N] f32: the column sums over the G q-heads of each
    kv-head and over the rows that count). A row counts when it lies below
    `length` ([B] int32, default N) and, with obs_window > 0, at or above
    length - obs_window.

    Logits are f32 products of the storage-dtype values (q is cast to K's
    dtype first), and the probabilities are rounded to V's dtype before
    the value product and the column sums, as the reference's bf16
    matmuls with f32 accumulation do."""
    b, hq, c, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    g = hq // hk
    chunk = min(chunk, c)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    if length is None:
        length = torch.full((b,), n, dtype=torch.int32, device=dev)
    length = torch.clamp(length.to(torch.int32), max=n)
    kt = k.float().transpose(-1, -2)                             # [B,Hk,d,N]
    vf = v.float()
    qs = q.to(k.dtype).float()
    col = torch.arange(n, device=dev)
    acc = torch.zeros((b, hk, n), dtype=torch.float32, device=dev)
    outs = []
    for r0 in range(0, c, chunk):
        t = min(chunk, c - r0)
        row = torch.arange(row0 + r0, row0 + r0 + t, device=dev)
        q_g = qs[:, :, r0:r0 + t].reshape(b, hk, g * t, d)
        logits = torch.matmul(q_g, kt).reshape(b, hk, g, t, n)
        causal = row[:, None] >= col[None, :]                    # [T,N]
        logits = torch.where(causal, logits * scale,
                             torch.full_like(logits, NEG_INF))
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        probs = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
        p_g = probs.to(v.dtype).float()                          # [B,Hk,g,T,N]
        out_c = torch.matmul(p_g.reshape(b, hk, g * t, n), vf)
        outs.append(out_c.reshape(b, hq, t, -1))
        live = row[None, :] < length[:, None]                    # [B,T]
        if obs_window > 0:
            live = live & (row[None, :] >= (length[:, None] - obs_window))
        w = live.float()[:, None, None, :, None]
        acc += (p_g * w).sum(dim=(2, 3))
    return torch.cat(outs, dim=2), acc
