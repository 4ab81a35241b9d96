"""Plain PyTorch versions of the Hopper kernels (the correctness contract).

Each function here is the port of the matching oracle in the reference's
`kernels/ref.py`. The CPU path runs it, and `chip_smoke.py` holds the
kernel against it on the card.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.quant import unpack_int4
from repro_torch.core.topk import (block_candidates, exact_topk,
                                   merge_candidates)

NEG_INF = -1e30
PROT_WIN = 1e30


def approx_score_ref(qq, qscale, kq, kscale, valid):
    """CAM-mode scores, the plain version of `kernels/approx_score.py`:
    qq [BH,G,d] int8, qscale [BH,G], kq [BH,S,d] int8, kscale [BH,S],
    valid [BH,S] → [BH,G,S] f32 = (qq·kq)·qscale·kscale, NEG_INF at invalid
    slots. The integer contraction is exact in f32 while every partial sum
    stays below 2^24: for ±127 codes up to d = 1040 (1040·127² < 2^24,
    `core/scoring.EXACT_MAX_D`), and for the packed mirror's codes in
    [-8, 7] at every shape the kernel accepts (|Σ| <= 128·8·4096 = 2^22).
    There it equals the reference's int32 one bit for bit."""
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


def race_keys(qq, qscale, mirror, mscale, valid, prot):
    """The decode kernels' CAM scores and selection values (shapes as in
    `fused_decode_ref`) → (raw [BH,G,S] f32 scores, NEG_INF at invalid
    slots; keys [BH,S]: the G rows' scores summed in row order, as the
    kernels add them, PROT_WIN at protected slots)."""
    g = qq.shape[1]
    # the integer contraction is exact in f32 (see core/scoring.py)
    raw = torch.matmul(qq.float(), mirror.float().transpose(1, 2))
    raw = raw * qscale.float()[..., None] * mscale.float()[:, None, :]
    raw = torch.where(valid[:, None, :] != 0, raw,
                      torch.full_like(raw, NEG_INF))            # [BH,G,S]
    ssel = raw[:, 0]
    for gi in range(1, g):
        ssel = ssel + raw[:, gi]
    return raw, torch.where(prot != 0, torch.full_like(ssel, PROT_WIN), ssel)


def decode_race(qq, qscale, mirror, mscale, valid, prot, *, select_k: int,
                num_blocks: int = 1):
    """The fused decode's CAM race (shapes as in `fused_decode_ref`) →
    (raw [BH,G,S] f32 scores, NEG_INF at invalid slots; idx [BH,select_k]
    the winners, block by block, each block's in race order).

    Scores the int8 mirror, sums them over the G rows in row order (as
    the kernels add them, so both race on the same values bit for bit;
    protected slots win), and races each of the `num_blocks` equal slot
    blocks for select_k / num_blocks winners, ties to the lower slot."""
    bh, s = valid.shape
    nb = num_blocks
    assert s % nb == 0 and select_k % nb == 0, (s, select_k, nb)
    k_loc, bs = select_k // nb, s // nb
    assert k_loc <= bs, (k_loc, bs)
    raw, ssel = race_keys(qq, qscale, mirror, mscale, valid, prot)
    _, idx = torch.sort(ssel.reshape(bh, nb, bs), dim=-1, descending=True,
                        stable=True)
    idx = (idx[..., :k_loc] + torch.arange(0, s, bs, device=idx.device)[
        :, None]).reshape(bh, select_k)                         # [BH,K]
    return raw, idx


def fused_decode_ref(q, qq, qscale, mirror, mscale, kscale, vscale, valid,
                     prot, k, v, *, select_k: int, num_blocks: int = 1):
    """Fused pruned decode: the plain version of `kernels/fused_decode.py`
    and (with `num_blocks == 1`) of `kernels/ragged_decode.py`.

      q [BH,G,d] float; qq [BH,G,d] int8; qscale [BH,G] f32;
      mirror [BH,S,d] int8; mscale, kscale, vscale [BH,S] f32;
      valid, prot [BH,S] int8; k [BH,S,d], v [BH,S,dv] float or int8
      → (out [BH,G,dv] f32, probs [BH,S] f32)

    Races as `decode_race` (the int8 mirror's scores summed over the G
    rows; protected slots win; each of the `num_blocks` equal slot blocks
    takes select_k / num_blocks winners, ties to the lower slot); gathers only
    the winners' K/V rows times kscale/vscale and runs one exact softmax
    attention over all of them. probs[s] = Σ_g softmax_g(score/√d),
    exactly 0 at invalid slots. Slots at or past a row's fill are invalid,
    so the ragged kernel's skipping of dead blocks and this path's masking
    agree."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    raw, idx = decode_race(qq, qscale, mirror, mscale, valid, prot,
                           select_k=select_k, num_blocks=num_blocks)

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


# ---------------------------------------------------------------------------
# The decode kernels' sharded route, stage by stage, on one rank's block of
# a cache whose slots are split over ranks: the plain versions of the
# kernels' stages (csrc/decode_long.cuh, LaunchShard). `kernels/ops.
# sharded_decode` runs them with the collectives between them.
# ---------------------------------------------------------------------------


def shard_score_ref(qq, qscale, mirror, mscale, valid, prot, scale: float):
    """Stage a, the score kernel on a block → (raw, keys) as `race_keys`
    and mz [BH,G,2]: each g's (max of raw·scale, Σ exp(raw·scale - max))
    over the block's valid slots (-inf and 0 where it has none)."""
    raw, keys = race_keys(qq, qscale, mirror, mscale, valid, prot)
    lg = raw * scale
    live = raw > NEG_INF / 2
    m = torch.where(live, lg, torch.full_like(lg, -math.inf)).amax(dim=-1)
    e = torch.where(live, torch.exp(lg - m[..., None]), torch.zeros_like(lg))
    return raw, keys, torch.stack([m, e.sum(dim=-1)], dim=-1)


def shard_attend_ref(q, k, v, kscale, vscale, valid, picks, scale: float):
    """Stage c, the race kernel's winner stage writing partials: attention
    over the valid winners this block holds, picks [BH,K] slots of the
    block (those outside [0, S) are another rank's) → (num [BH,G,dv] =
    Σ exp(l - mx)·v, mx [BH,G] (-inf where it holds none), den [BH,G] =
    Σ exp(l - mx)), logits l = q·(k·kscale)·scale over the valid winners."""
    s = valid.shape[1]
    mine = (picks >= 0) & (picks < s)
    idx = picks.clamp(0, s - 1)

    def rows(x, sc):
        y = torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))
        return y.float() * torch.gather(sc.float(), 1, idx)[..., None]

    k_sel, v_sel = rows(k, kscale), rows(v, vscale)
    ok = mine & (torch.gather(valid, 1, idx) != 0)              # [BH,K]
    logits = torch.matmul(q.float(), k_sel.transpose(1, 2)) * scale
    logits = torch.where(ok[:, None, :], logits,
                         torch.full_like(logits, -math.inf))
    mx = logits.amax(dim=-1)
    e = torch.where(ok[:, None, :], torch.exp(logits - mx[..., None]),
                    torch.zeros_like(logits))
    return torch.matmul(e, v_sel), mx, e.sum(dim=-1)


def shard_probs_ref(raw, mz, scale: float):
    """Stage d, the probs kernel with the row's merged mz [BH,G,2]:
    probs[s] = Σ_g exp(raw·scale - M_g) / Z_g, exactly 0 at invalid
    slots."""
    live = raw > NEG_INF / 2
    e = torch.where(live, torch.exp(raw * scale - mz[..., 0:1]),
                    torch.zeros_like(raw))
    return (e / torch.clamp(mz[..., 1:2], min=1e-30)).sum(dim=1)


class ShardStagesRef:
    """The plain stages of the sharded route on one rank's block (the CPU's;
    `kernels/ragged_decode.ShardStages` holds the kernels'), with the
    interface `ops.sharded_decode` drives: `race` (score, then the block's
    race: the global race's candidates, or the blocked race's final
    winners and their partials), `candidates` / `merge` (the global race's
    gathered candidates raced again), `attend`, `mz` / `set_mz`, `probs`
    and `partials`. Inputs as `fused_decode_ref`'s, for the block."""

    def __init__(self, q, qq, qscale, mirror, mscale, kscale, vscale, valid,
                 prot, k, v, offset: int):
        self.q, self.k, self.v = q, k, v
        self.kscale, self.vscale, self.valid = kscale, vscale, valid
        self.offset, self.slots = offset, valid.shape[1]
        self.scale = 1.0 / math.sqrt(q.shape[-1])
        self.raw, self.keys, self._mz = shard_score_ref(
            qq, qscale, mirror, mscale, valid, prot, self.scale)
        self.picks = self.cand = self._part = None

    def race(self, k: int, final: bool) -> None:
        """The block's top k keys: the final winners (`final`, then their
        partials), or the global race's candidates."""
        if final:
            _, self.picks = exact_topk(self.keys, k)
            self.attend()
        else:
            self.cand = block_candidates(self.keys, k, self.offset)

    def candidates(self):
        return self.cand

    def merge(self, gathered, k: int) -> None:
        self.picks = merge_candidates(gathered, k) - self.offset

    def attend(self) -> None:
        self._part = shard_attend_ref(self.q, self.k, self.v, self.kscale,
                                      self.vscale, self.valid, self.picks,
                                      self.scale)

    def mz(self):
        return self._mz

    def set_mz(self, mz) -> None:
        self._mz = mz

    def winners(self):
        return self.picks + self.offset

    def probs(self):
        return shard_probs_ref(self.raw, self._mz, self.scale)

    def partials(self):
        return self._part


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
                          scale=None, den_f64: bool = False):
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
    matmuls with f32 accumulation do. `den_f64` sums each softmax
    denominator in f64 and rounds it to f32 (the exact sum's rounding,
    whatever the order): the denominator the kernel's latent route gives
    its exact rows."""
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
        den = (e.sum(dim=-1, keepdim=True, dtype=torch.float64).float()
               if den_f64 else e.sum(dim=-1, keepdim=True))
        probs = e / torch.clamp(den, min=1e-30)
        p_g = probs.to(v.dtype).float()                          # [B,Hk,g,T,N]
        out_c = torch.matmul(p_g.reshape(b, hk, g * t, n), vf)
        outs.append(out_c.reshape(b, hq, t, -1))
        live = row[None, :] < length[:, None]                    # [B,T]
        if obs_window > 0:
            live = live & (row[None, :] >= (length[:, None] - obs_window))
        w = live.float()[:, None, None, :, None]
        acc += (p_g * w).sum(dim=(2, 3))
    return torch.cat(outs, dim=2), acc


def flash_prefill_bwd_ref(q, k, v, dout, *, scale=None, chunk: int = 512):
    """The backward of causal prompt attention, the plain version of the
    `flash_prefill_bwd` kernel: the gradient of the out that
    `prefill_attention_ref` computes (the reference's
    `chunked_causal_attention` under `jax.vjp`), its column sums getting
    no cotangent. q [B,Hq,N,d], k/v [B,Hk,N,d], dout [B,Hq,N,dv] (out's
    cotangent) → (dq in q's dtype, dk, dv in K's and V's dtypes, each
    summed over the Hq / Hk q-heads of its group), written out step by
    step, `chunk` query rows at a time.

    It rounds where the reference's vjp rounds: the cotangent of a bf16
    operand of an f32-accumulating product is bf16, so dP = dout·vᵀ is
    rounded to V's dtype before the softmax backward, dq to K's dtype (q
    is cast to it in the forward) and then to q's, and dk and dv to their
    dtypes; the rows' sums are f32, rounded once. dv takes the
    probabilities rounded to V's dtype, the operand of the forward's p·v;
    the softmax backward takes them in f32. (With more rows than the
    reference's 512-row chunk, the reference rounds each chunk's dk and dv
    to bf16 and sums those in bf16; this version and the kernel sum every
    row in f32.)"""
    b, hq, n, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    dv_dim = v.shape[-1]
    chunk = min(chunk, n)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    dev = q.device
    qs = q.to(k.dtype).float()
    kf, vf = k.float(), v.float()
    do = dout.float()
    col = torch.arange(n, device=dev)
    dk = torch.zeros((b, hk, n, d), dtype=torch.float32, device=dev)
    dv = torch.zeros((b, hk, n, dv_dim), dtype=torch.float32, device=dev)
    dqs = []
    for r0 in range(0, n, chunk):
        t = min(chunk, n - r0)
        row = torch.arange(r0, r0 + t, device=dev)
        q_g = qs[:, :, r0:r0 + t].reshape(b, hk, g * t, d)
        do_g = do[:, :, r0:r0 + t].reshape(b, hk, g * t, dv_dim)
        logits = torch.matmul(q_g, kf.transpose(-1, -2)).reshape(
            b, hk, g, t, n)
        causal = row[:, None] >= col[None, :]
        logits = torch.where(causal, logits * scale,
                             torch.full_like(logits, NEG_INF))
        m = logits.amax(dim=-1, keepdim=True)
        e = torch.exp(logits - m)
        p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
        p_round = p.to(v.dtype).float().reshape(b, hk, g * t, n)
        dv += torch.matmul(p_round.transpose(-1, -2), do_g)
        dp = torch.matmul(do_g, vf.transpose(-1, -2)).to(v.dtype).float()
        dp = dp.reshape(b, hk, g, t, n)
        dd = (p * dp).sum(dim=-1, keepdim=True)
        ds = (p * (dp - dd) * scale).reshape(b, hk, g * t, n)
        dqs.append(torch.matmul(ds, kf).to(k.dtype).reshape(b, hq, t, d))
        dk += torch.matmul(ds.transpose(-1, -2), q_g)
    dq = torch.cat(dqs, dim=2).to(q.dtype)
    return dq, dk.to(k.dtype), dv.to(v.dtype)


def latent_du(dk, dv):
    """The latent's gradient from `flash_prefill_bwd_ref`'s dk [B,1,N,d]
    and dv [B,1,N,dv] (MLA: K the latent, V the view of its first dv
    columns): dk + [dv, 0], summed in f32 and rounded once to dk's dtype,
    the sum autograd makes of the two views' gradients (the plain version
    of the kernel's latent-route du)."""
    pad = torch.nn.functional.pad(dv.float(), (0, dk.shape[-1] - dv.shape[-1]))
    return (dk.float() + pad).to(dk.dtype)


def split_bf16_ref(x):
    """An f32 tensor as bf16 hi = bf16(x) and lo = bf16(x - hi), stacked
    [2, *x.shape]: the plain version of the latent route's dout split."""
    hi = x.to(torch.bfloat16)
    return torch.stack((hi, (x - hi.float()).to(torch.bfloat16)))


def split_bf16_cases(shape, generator):
    """f32 values of `shape` (at least 8 elements) on `generator`'s device
    to hold a dout split to `split_bf16_ref` on: normal values over 60
    binades, the first eight zeros of both signs, subnormals, the f32
    extremes and two values beside a bf16 rounding tie."""
    dev = generator.device
    x = torch.randn(shape, generator=generator, device=dev)
    x = x * torch.exp2(torch.randint(-30, 30, x.shape, generator=generator,
                                     device=dev).float())
    x.view(-1)[:8] = torch.tensor([0.0, -0.0, 1e-40, -3e-39, 3e38, -3e38,
                                   1.0 + 2 ** -9, 1.0 - 2 ** -10], device=dev)
    return x


def flash_prefill_bwd_dq_flip(q, k, v, dout, *, scale=None,
                              chunk: int = 256):
    """How far each element of `flash_prefill_bwd_ref`'s dq moves when one
    dP element of its row rounds to its other bf16 neighbour: scale ·
    max_j(P_ij · ulp(dP_ij)) · (max_j |k_jc| + |sum_j P_ij k_jc|), [B, Hq,
    N, d] f32 (a flip of dP_ij by u moves dS_ij by P_ij u scale and, through
    D_i, every dS_ij' by -P_ij' P_ij u scale). dP is rounded to V's dtype
    after an f32 sum, so an implementation that sums dout · v in another
    order rounds the elements near a rounding midpoint the other way; where
    dP - D cancels over a row, one such flip moves its dq by more than a
    bf16 ulp of its largest element. Zeros for an f32 V (no rounding)."""
    b, hq, n, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    dev = q.device
    out = torch.zeros((b, hq, n, d), dtype=torch.float32, device=dev)
    if v.dtype == torch.float32:
        return out
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qs, kf, vf, do = q.to(k.dtype).float(), k.float(), v.float(), \
        dout.float()
    kmax = kf.abs().amax(dim=2, keepdim=True)[:, :, None]    # [B,Hk,1,1,d]
    col = torch.arange(n, device=dev)
    for r0 in range(0, n, chunk):
        t = min(chunk, n - r0)
        row = torch.arange(r0, r0 + t, device=dev)
        q_g = qs[:, :, r0:r0 + t].reshape(b, hk, g * t, d)
        logits = torch.matmul(q_g, kf.transpose(-1, -2)).reshape(
            b, hk, g, t, n)
        logits = torch.where(row[:, None] >= col[None, :], logits * scale,
                             torch.full_like(logits, NEG_INF))
        p = torch.softmax(logits, dim=-1)
        del logits
        dp = torch.matmul(do[:, :, r0:r0 + t].reshape(b, hk, g * t, -1),
                          vf.transpose(-1, -2)).to(v.dtype).float()
        _, e = torch.frexp(dp.reshape(b, hk, g, t, n))
        w = (p * torch.ldexp(torch.ones_like(p), e - 8)).amax(-1, True)
        del dp, e
        o = torch.matmul(p.reshape(b, hk, g * t, n), kf).reshape(
            b, hk, g, t, d)
        out[:, :, r0:r0 + t] = (scale * w * (kmax + o.abs())).reshape(
            b, hq, t, d)
    return out

