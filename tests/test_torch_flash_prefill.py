"""The port's prompt attention against the reference.

- `ref.flash_prefill_ref` (the TPU contract) against the reference's
  `flash_prefill` in interpret mode and its oracle, at the shapes, length
  mask and bf16 case of the reference's kernel tests, with their
  tolerances (out 2e-5, acc 2e-4 in f32; out 5e-2 in bf16);
- `ops.prefill_attention` on CPU tensors (the model's contract) against
  the reference's `chunked_causal_attention` (row0 = 0) and
  `prefill_chunk_attend` (row0 > 0 into a longer buffer), 1e-5;
- a blocked emulation of the f32 route's tiling (64-row query blocks,
  64-column K tiles, masked tiles skipped, two passes, per-block column
  partials folded in order): held to the plain version at 1e-5, ragged N
  included, and its chunked use (row0 a multiple of the block, acc
  accumulated in place) equal to its whole-prompt use bit for bit. It
  holds the kernel's algorithm, though not its CUDA code, to the contract;
- a blocked emulation of the bf16 (tensor-core) route: bf16 inputs, column
  sums per 16-row warp in the kernel's shuffle order and then in warp
  order, and with f32 probabilities a value product of hi + lo bf16
  halves: held to both plain versions at the tolerances the card's checks
  use, and chunked equal to whole bit for bit; the hi/lo split keeps p to
  2^-16 relative;
- the bf16 route's exact rows: with the rows whose softmax denominator is
  below `EXACT_BELOW` kept at the plain logits, logit noise in all other
  rows leaves out within 1e-3, and those rows' probabilities are small
  enough that a bf16 flip moves out by 2^-13 |v| at most;
- on a card only, the kernel against its plain version, both contracts
  and both routes, chunked against whole prompt bit for bit, and the
  exact rows changing no other row.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_prefill as flash_mod
from repro_torch.kernels import ops, ref

NEG_INF = -1e30
BQ, BK = flash_mod.BLOCK_Q, flash_mod.BLOCK_K


def _np(x):
    return x.detach().cpu().float().numpy()


# ---------------------------------------------------------------------------
# the TPU contract against the reference's kernel (interpret mode)
# ---------------------------------------------------------------------------


def _jax():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platform_name", "cpu")
    import jax.numpy as jnp
    from repro.kernels import ref as jref
    from repro.kernels.flash_prefill import flash_prefill as jflash
    return jnp, jref, jflash


def _tpu_inputs(bh, bk, n, d, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((bh, n, d)).astype(dtype),
            rng.standard_normal((bk, n, d)).astype(dtype),
            rng.standard_normal((bk, n, d)).astype(dtype))


@pytest.mark.parametrize("b,hq,hk,n,d,bq,bk", [
    (1, 2, 1, 128, 32, 32, 32),
    (2, 4, 2, 128, 64, 64, 32),
    (1, 2, 2, 256, 32, 64, 64),
])
def test_flash_prefill_ref_matches_reference_kernel(b, hq, hk, n, d, bq, bk):
    jnp, jref, jflash = _jax()
    g = hq // hk
    q, k, v = _tpu_inputs(b * hq, b * hk, n, d, n + d)
    jout, jacc = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        group=g, block_q=bq, block_k=bk, interpret=True)
    rout, racc = jref.flash_prefill_ref(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), group=g)
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    for out, acc in (ref.flash_prefill_ref(tq, tk, tv, group=g),
                     ops.flash_prefill(tq, tk, tv, group=g)):
        for want_out, want_acc in ((jout, jacc), (rout, racc)):
            np.testing.assert_allclose(_np(out), np.asarray(want_out),
                                       atol=2e-5, rtol=0)
            np.testing.assert_allclose(_np(acc), np.asarray(want_acc),
                                       atol=2e-4, rtol=0)
        np.testing.assert_allclose(_np(acc).sum(-1), np.full(b * hq, n),
                                   rtol=1e-4)


def test_flash_prefill_ref_lengths_mask_matches_reference_kernel():
    jnp, jref, jflash = _jax()
    b, hq, hk, n, d, t = 1, 4, 2, 128, 32, 80
    g = hq // hk
    q, k, v = _tpu_inputs(b * hq, b * hk, n, d, 42)
    lengths = np.full((b * hq,), t, np.int32)
    jout, jacc = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        group=g, block_q=32, block_k=32, interpret=True,
                        lengths=jnp.asarray(lengths))
    tq, tk, tv = map(torch.as_tensor, (q, k, v))
    out, acc = ops.flash_prefill(tq, tk, tv, group=g,
                                 lengths=torch.as_tensor(lengths))
    np.testing.assert_allclose(_np(out)[:, :t], np.asarray(jout)[:, :t],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(_np(acc), np.asarray(jacc), atol=2e-4, rtol=0)
    assert not acc[:, t:].any()          # pad columns get no mass
    np.testing.assert_allclose(_np(acc).sum(-1), np.full(b * hq, t),
                               rtol=1e-4)


def test_flash_prefill_ref_bf16_matches_reference_kernel():
    jnp, jref, jflash = _jax()
    b, hq, hk, n, d = 1, 2, 1, 64, 32
    q, k, v = _tpu_inputs(b * hq, b * hk, n, d, 0)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    jout, _ = jflash(jq, jk, jv, group=2, block_q=32, block_k=32,
                     interpret=True)
    tq, tk, tv = (torch.as_tensor(np.asarray(x, np.float32)).to(torch.bfloat16)
                  for x in (jq, jk, jv))
    out, _ = ops.flash_prefill(tq, tk, tv, group=2)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_np(out), np.asarray(jout, np.float32),
                               atol=5e-2, rtol=0)


# ---------------------------------------------------------------------------
# the model's contract against chunked_causal_attention / prefill_chunk_attend
# ---------------------------------------------------------------------------


def _model_inputs(b, hq, hk, n, d, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, n, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, n, d)).astype(np.float32)
    return tuple(torch.as_tensor(x).to(dtype) for x in (q, k, v))


def _live_rows(length, b, n, row0=0, c=None):
    c = n if c is None else c
    rows = row0 + np.arange(c)
    ln = np.full(b, n) if length is None else np.asarray(length)
    return rows[None, :] < ln[:, None]                          # [B, C]


@pytest.mark.parametrize("hq,hk,length,obs", [
    (4, 4, None, 0), (4, 2, [45, 20], 0), (8, 2, [45, 11], 8),
    (4, 1, [30, 45], 16),
])
def test_prefill_attention_matches_reference_chunked(hq, hk, length, obs):
    jnp, _, _ = _jax()
    from repro.core.attention import chunked_causal_attention as jchunked
    b, n, d = 2, 45, 16
    q, k, v = _model_inputs(b, hq, hk, n, d, hq * 10 + obs)
    ln = None if length is None else np.asarray(length, np.int32)
    jo, ja = jchunked(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                      jnp.asarray(v.numpy()), chunk=16, obs_window=obs,
                      length=None if ln is None else jnp.asarray(ln))
    to, ta = ops.prefill_attention(
        q, k, v, row0=0, length=None if ln is None else torch.as_tensor(ln),
        obs_window=obs, chunk=16)
    live = _live_rows(ln, b, n)[:, None, :].repeat(hq, 1)
    np.testing.assert_allclose(_np(to)[live], np.asarray(jo)[live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ta), np.asarray(ja), atol=1e-5, rtol=0)


@pytest.mark.parametrize("hq,hk,row0,c,n,length,obs", [
    (4, 2, 16, 16, 64, [40, 64], 0),
    (4, 1, 32, 16, 80, [40, 70], 8),
    (2, 2, 48, 32, 96, [90, 57], 0),
])
def test_prefill_attention_matches_reference_chunk_attend(hq, hk, row0, c, n,
                                                          length, obs):
    jnp, _, _ = _jax()
    from repro.core.attention import prefill_chunk_attend as jattend
    b, d = 2, 16
    q, k, v = _model_inputs(b, hq, hk, n, d, row0 + c)
    q_c = q[:, :, row0:row0 + c]
    ln = np.asarray(length, np.int32)
    jo, ja = jattend(jnp.asarray(q_c.numpy()), jnp.asarray(k.numpy()),
                     jnp.asarray(v.numpy()), jnp.asarray(row0, jnp.int32),
                     jnp.asarray(ln), obs_window=obs)
    acc0 = torch.full((b, hk, n), 0.25)
    acc = acc0.clone()
    to, ta = ops.prefill_attention(q_c, k, v, acc, row0=row0,
                                   length=torch.as_tensor(ln),
                                   obs_window=obs)
    assert ta is acc                                 # added in place
    live = _live_rows(ln, b, n, row0, c)[:, None, :].repeat(hq, 1)
    np.testing.assert_allclose(_np(to)[live], np.asarray(jo)[live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(_np(ta - acc0), np.asarray(ja), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# a blocked emulation of the CUDA kernel's tiling
# ---------------------------------------------------------------------------


def _emulate(q, k, v, lengths, acc, *, group, acc_group, row0, obs_window,
             scale, tile_step):
    """The grid both routes of `csrc/flash_prefill.cu` walk, tile for tile:
    per 64-row query block, the 64-column K tiles its last row sees (masked
    tiles skipped); sweep 1 the online row statistics; sweep 2 the exactly
    normalised p of each tile, whose column sums and value product come
    from `tile_step(p, counts [BH,BQ], v_tile) -> (cs [BH,BK], out
    increment [BH,BQ,d])`; then the fold of the per-block partials into
    acc (+= in place) in q-block, then head order. q [BH,C,d], k/v
    [BH/group,N,d], lengths [BH] → out [BH,C,d] f32."""
    bh, c, d = q.shape
    n = k.shape[1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    nqb = math.ceil(c / BQ)
    kx = k.float()[torch.arange(bh) // group]
    vx = v.float()[torch.arange(bh) // group]
    part = torch.zeros((bh, nqb, n))
    out = torch.zeros((bh, c, d))
    lengths = lengths.long()
    for qb in range(nqb):
        r_lo = qb * BQ
        rows = min(BQ, c - r_lo)
        qt = torch.zeros((bh, BQ, d))
        qt[:, :rows] = q[:, r_lo:r_lo + rows].float()
        row = row0 + r_lo + torch.arange(BQ)
        counts = ((torch.arange(BQ) < rows)[None]
                  & (row[None] < lengths[:, None]))
        if obs_window > 0:
            counts &= row[None] >= lengths[:, None] - obs_window
        ntiles = (row0 + r_lo + rows - 1) // BK + 1

        def tile(kt):
            col = kt * BK + torch.arange(BK)
            nv = min(BK, n - kt * BK)
            kt_, vt_ = torch.zeros((bh, BK, d)), torch.zeros((bh, BK, d))
            kt_[:, :nv] = kx[:, kt * BK:kt * BK + nv]
            vt_[:, :nv] = vx[:, kt * BK:kt * BK + nv]
            s = torch.matmul(qt, kt_.transpose(1, 2)) * scale
            live = (col[None, :] <= row[:, None]) & (col[None, :] < n)
            return torch.where(live, s, torch.full_like(s, NEG_INF)), vt_, nv

        m = torch.full((bh, BQ), NEG_INF)
        l_ = torch.zeros((bh, BQ))
        for kt in range(ntiles):                       # sweep 1
            s, _, _ = tile(kt)
            m_new = torch.maximum(m, s.amax(-1))
            l_ = l_ * torch.exp(m - m_new) + torch.exp(
                s - m_new[..., None]).sum(-1)
            m = m_new
        den = torch.clamp(l_, min=1e-30)
        o = torch.zeros((bh, BQ, d))
        for kt in range(ntiles):                       # sweep 2
            s, vt_, nv = tile(kt)
            p = torch.exp(s - m[..., None]) / den[..., None]
            cs, do = tile_step(p, counts.float(), vt_)
            part[:, qb, kt * BK:kt * BK + nv] = cs[:, :nv]
            o = o + do
        out[:, r_lo:r_lo + rows] = o[:, :rows]
    # the fold: q-block order, then the summed q-heads in head order
    parts = part.reshape(bh // acc_group, acc_group, nqb, n)
    for qb in range(nqb):
        reach = ((row0 + min((qb + 1) * BQ, c) - 1) // BK + 1) * BK
        for g in range(acc_group):
            acc[:, :reach] += parts[:, g, qb, :reach]
    return out


def emulate_kernel(q, k, v, lengths, acc, *, group, acc_group, row0=0,
                   obs_window=0, round_p=False, scale=None):
    """The f32 route of `csrc/flash_prefill.cu` (`flash_prefill_f32_kernel`
    and the column fold), tile for tile (`_emulate`): each tile's column
    sums run over the block's 64 rows in row order."""
    def step(p, w, vt):
        if round_p:
            p = p.to(torch.bfloat16).float()
        cs = torch.zeros((p.shape[0], BK))
        for r in range(BQ):                            # row order
            cs = cs + p[:, r] * w[:, r, None]
        return cs, torch.matmul(p, vt)

    return _emulate(q, k, v, lengths, acc, group=group, acc_group=acc_group,
                    row0=row0, obs_window=obs_window, scale=scale,
                    tile_step=step)


EMULATION_CASES = [  # b, hq, hk, n, d, lengths, obs, v dtype
    (1, 2, 1, 200, 16, None, 0, torch.float32),
    (2, 4, 2, 130, 16, [130, 77], 0, torch.float32),
    (2, 8, 2, 256, 32, [250, 100], 32, torch.float32),
    (1, 4, 4, 129, 16, [129], 8, torch.float32),
]


@pytest.mark.parametrize("b,hq,hk,n,d,length,obs,dtype", EMULATION_CASES)
def test_kernel_emulation_matches_plain_version(b, hq, hk, n, d, length, obs,
                                                dtype):
    q, k, v = _model_inputs(b, hq, hk, n, d, n + hq, dtype)
    ln = torch.full((b,), n, dtype=torch.int32) if length is None else (
        torch.as_tensor(length, dtype=torch.int32))
    g = hq // hk
    acc = torch.zeros((b * hk, n))
    out = emulate_kernel(q.reshape(b * hq, n, d), k.reshape(b * hk, n, d),
                         v.reshape(b * hk, n, d), ln.repeat_interleave(hq),
                         acc, group=g, acc_group=g, obs_window=obs)
    want_out, want_acc = ref.prefill_attention_ref(q, k, v, length=ln,
                                                   obs_window=obs, chunk=64)
    torch.testing.assert_close(out.reshape(b, hq, n, d), want_out, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(acc.reshape(b, hk, n), want_acc, rtol=0,
                               atol=1e-5)
    for bi in range(b):                  # columns past the length get no mass
        assert not acc.reshape(b, hk, n)[bi, :, int(ln[bi]):].any()
    # the TPU contract: f32 probabilities, acc per q-head
    acc1 = torch.zeros((b * hq, n))
    qf, kf, vf = (x.reshape(-1, n, d) for x in (q, k, v))
    out1 = emulate_kernel(qf, kf, vf, ln.repeat_interleave(hq), acc1,
                          group=g, acc_group=1)
    want1, want_acc1 = ref.flash_prefill_ref(qf, kf, vf, group=g,
                                             lengths=ln.repeat_interleave(hq))
    torch.testing.assert_close(out1, want1, rtol=0, atol=1e-5)
    torch.testing.assert_close(acc1, want_acc1, rtol=0, atol=1e-5)


@pytest.mark.parametrize("hq,hk,n,c,obs", [(4, 2, 256, 64, 0),
                                           (8, 2, 320, 128, 24)])
def test_kernel_emulation_chunked_equals_whole_bit_for_bit(hq, hk, n, c, obs):
    """Chunks of a multiple of the 64-row block, their column sums added
    into one running acc, give the whole-prompt call's column sums and
    outputs exactly."""
    b, d = 2, 16
    q, k, v = _model_inputs(b, hq, hk, n, d, n + c)
    q, k, v = q.reshape(b * hq, n, d), k.reshape(b * hk, n, d), \
        v.reshape(b * hk, n, d)
    ln = torch.as_tensor([n - 5, n // 2 + 3], dtype=torch.int32
                         ).repeat_interleave(hq)
    g = hq // hk
    acc_w = torch.zeros((b * hk, n))
    out_w = emulate_kernel(q, k, v, ln, acc_w, group=g, acc_group=g,
                           obs_window=obs)
    acc_c = torch.zeros((b * hk, n))
    outs = [emulate_kernel(q[:, r0:r0 + c].contiguous(), k, v, ln, acc_c,
                           group=g, acc_group=g, row0=r0, obs_window=obs)
            for r0 in range(0, n, c)]
    assert torch.equal(acc_c, acc_w)
    assert torch.equal(torch.cat(outs, dim=1), out_w)


# ---------------------------------------------------------------------------
# a blocked emulation of the bf16 route (tensor cores)
# ---------------------------------------------------------------------------

WARP_ROWS = 16                           # query rows per warp of the route


def split_bf16(p):
    """hi = bf16(p), lo = bf16(p - hi): the two A operands of the bf16
    route's value product when the probabilities stay f32."""
    hi = p.to(torch.bfloat16)
    return hi, (p - hi.float()).to(torch.bfloat16)


def warp_column_sums(pw):
    """pw [BH, 16, BK]: one warp's p x (row counts). Its column sums in the
    kernel's order: the two rows g and g + 8 of each lane quad, then the
    shuffle tree over lane offsets 4, 8 and 16 (neighbouring g's, then
    pairs of them, then the two halves)."""
    x = pw[:, :8] + pw[:, 8:]                          # [BH, 8, BK] by g
    x = x[:, 0::2] + x[:, 1::2]                        # offset 4
    x = x[:, 0::2] + x[:, 1::2]                        # offset 8
    return x[:, 0] + x[:, 1]                           # offset 16


def emulate_tc_kernel(q, k, v, lengths, acc, *, group, acc_group, row0=0,
                      obs_window=0, round_p=True, scale=None):
    """The bf16 route of `csrc/flash_prefill.cu` (`flash_prefill_tc_kernel`
    and the column fold), tile for tile (`_emulate`), on bf16 inputs: each
    tile's column sums are summed per 16-row warp (`warp_column_sums`),
    then over the 4 warps in warp order; with `round_p` False the value
    product is hi @ V + lo @ V and the column sums take the unrounded p.
    The kernel's exact rows are not told apart: here every logit is the
    same f32 product, where the card sums those rows' logits in the plain
    GEMM's order and the others on the tensor cores."""
    assert q.dtype == k.dtype == v.dtype == torch.bfloat16

    def step(p, w, vt):
        hi, lo = split_bf16(p)
        if round_p:
            p = hi.float()
        pw = p * w[..., None]
        cs = warp_column_sums(pw[:, :WARP_ROWS])
        for wi in range(1, BQ // WARP_ROWS):           # warp order
            cs = cs + warp_column_sums(
                pw[:, wi * WARP_ROWS:(wi + 1) * WARP_ROWS])
        do = torch.matmul(hi.float(), vt)
        if not round_p:
            do = do + torch.matmul(lo.float(), vt)
        return cs, do

    return _emulate(q, k, v, lengths, acc, group=group, acc_group=acc_group,
                    row0=row0, obs_window=obs_window, scale=scale,
                    tile_step=step)


# the tolerances the card's checks hold the bf16 route to: bf16-rounded
# probabilities (model contract) flip at a rounding boundary under another
# summation order, by one bf16 ulp of a term (2^-7 of a column sum at
# most); f32 probabilities (TPU contract) keep the sums to 1e-4, and out
# is bf16 on both sides (one ulp, 2^-7 relative)
TC_OUT_ATOL, TC_MODEL_ACC_RTOL, TC_TPU_ACC_RTOL = 1e-3, 2.0 ** -7, 1e-4

TC_EMULATION_CASES = [  # b, hq, hk, n, d, lengths, obs
    (1, 2, 1, 200, 32, None, 0),
    (2, 4, 2, 130, 16, [130, 77], 0),
    (2, 8, 2, 256, 64, [250, 100], 32),
    (1, 4, 4, 129, 128, [129], 8),
]


@pytest.mark.parametrize("b,hq,hk,n,d,length,obs", TC_EMULATION_CASES)
def test_tc_emulation_matches_plain_version(b, hq, hk, n, d, length, obs):
    q, k, v = _model_inputs(b, hq, hk, n, d, n + hq + d, torch.bfloat16)
    ln = torch.full((b,), n, dtype=torch.int32) if length is None else (
        torch.as_tensor(length, dtype=torch.int32))
    g = hq // hk
    acc = torch.zeros((b * hk, n))
    out = emulate_tc_kernel(q.reshape(b * hq, n, d), k.reshape(b * hk, n, d),
                            v.reshape(b * hk, n, d), ln.repeat_interleave(hq),
                            acc, group=g, acc_group=g, obs_window=obs)
    want_out, want_acc = ref.prefill_attention_ref(q, k, v, length=ln,
                                                   obs_window=obs, chunk=64)
    torch.testing.assert_close(out.reshape(b, hq, n, d), want_out, rtol=0,
                               atol=TC_OUT_ATOL)
    torch.testing.assert_close(acc.reshape(b, hk, n), want_acc,
                               rtol=TC_MODEL_ACC_RTOL, atol=0)
    for bi in range(b):                  # columns past the length get no mass
        assert not acc.reshape(b, hk, n)[bi, :, int(ln[bi]):].any()
    # the TPU contract: f32 probabilities (hi + lo), acc per q-head, out in
    # q's dtype
    acc1 = torch.zeros((b * hq, n))
    qf, kf, vf = (x.reshape(-1, n, d) for x in (q, k, v))
    lens = ln.repeat_interleave(hq)
    out1 = emulate_tc_kernel(qf, kf, vf, lens, acc1, group=g, acc_group=1,
                             round_p=False).to(torch.bfloat16)
    want1, want_acc1 = ref.flash_prefill_ref(qf, kf, vf, group=g,
                                             lengths=lens)
    torch.testing.assert_close(out1.float(), want1.float(), rtol=2.0 ** -7,
                               atol=TC_OUT_ATOL)
    torch.testing.assert_close(acc1, want_acc1, rtol=TC_TPU_ACC_RTOL, atol=0)


@pytest.mark.parametrize("hq,hk,n,c,obs,round_p", [
    (4, 2, 256, 64, 0, True), (8, 2, 320, 128, 24, True),
    (4, 4, 256, 128, 0, False)])
def test_tc_emulation_chunked_equals_whole_bit_for_bit(hq, hk, n, c, obs,
                                                       round_p):
    """Chunks of a multiple of the 64-row block give the whole-prompt
    call's column sums and outputs exactly, on the bf16 route too."""
    b, d = 2, 32
    q, k, v = _model_inputs(b, hq, hk, n, d, n + c + 1, torch.bfloat16)
    q, k, v = q.reshape(b * hq, n, d), k.reshape(b * hk, n, d), \
        v.reshape(b * hk, n, d)
    ln = torch.as_tensor([n - 5, n // 2 + 3], dtype=torch.int32
                         ).repeat_interleave(hq)
    g = hq // hk
    ag = g if round_p else 1
    acc_w = torch.zeros((b * hq // ag, n))
    out_w = emulate_tc_kernel(q, k, v, ln, acc_w, group=g, acc_group=ag,
                              obs_window=obs, round_p=round_p)
    acc_c = torch.zeros_like(acc_w)
    outs = [emulate_tc_kernel(q[:, r0:r0 + c].contiguous(), k, v, ln, acc_c,
                              group=g, acc_group=ag, row0=r0, obs_window=obs,
                              round_p=round_p)
            for r0 in range(0, n, c)]
    assert torch.equal(acc_c, acc_w)
    assert torch.equal(torch.cat(outs, dim=1), out_w)


def test_hi_lo_split_keeps_f32_probabilities():
    """bf16(p) + bf16(p - bf16(p)) is p to within 2^-16 relative: the TPU
    contract's value product on the bf16 route keeps f32 probabilities
    that far."""
    rng = np.random.default_rng(3)
    s = torch.as_tensor(rng.standard_normal((64, 512)) * 6,
                        dtype=torch.float32)
    p = torch.softmax(s, dim=-1)
    p = torch.cat([p.flatten(), torch.as_tensor(
        rng.uniform(1e-30, 1.0, 4096), dtype=torch.float32)])
    p = p[p > 0]
    hi, lo = split_bf16(p)
    back = hi.float() + lo.float()
    rel = ((back - p).abs() / p).max()
    assert rel <= 2.0 ** -16, float(rel)
    assert ((hi.float() - p).abs() / p).max() > 2.0 ** -16  # hi alone: no


def _noisy_model_out(q, k, v, noisy_rows, ulps, seed):
    """The model contract's out through the plain version's arithmetic
    with the logits of `noisy_rows` ([B, Hq, N] bool) moved by up to
    `ulps` f32 ulps, as a summation order other than the plain GEMM's moves
    them; the other rows keep the plain logits."""
    b, hq, n, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    logits = torch.matmul(q.float().reshape(b, hk, g * n, d),
                          k.float().transpose(-1, -2)).reshape(b, hq, n, n)
    u = np.random.default_rng(seed).uniform(-ulps, ulps, tuple(logits.shape))
    moved = logits * (1 + torch.as_tensor(u, dtype=torch.float32) * 2.0 ** -24)
    logits = torch.where(noisy_rows[..., None], moved, logits)
    causal = torch.tril(torch.ones((n, n), dtype=torch.bool))
    logits = torch.where(causal, logits * (1.0 / math.sqrt(d)),
                         torch.full_like(logits, NEG_INF))
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    p = (e / e.sum(dim=-1, keepdim=True)).to(torch.bfloat16).float()
    return torch.matmul(p.reshape(b, hk, g * n, n), v.float()).reshape(
        b, hq, n, d), e.sum(dim=-1)


def test_exact_rows_keep_out_within_atol_under_logit_noise():
    """The bf16 route's exact rows: logits summed in another order (64 f32
    ulps here, more than the tensor cores move them) flip some
    bf16-rounded probabilities. With the rows whose denominator l is below
    EXACT_BELOW kept exact, every flip lies in a row whose probabilities
    are below 1/EXACT_BELOW, and out stays within the card's 1e-3 of the
    plain version; with every row moved, the large probabilities of the
    early rows flip and out leaves it."""
    b, hq, hk, n, d = 1, 8, 4, 256, 64
    q, k, v = _model_inputs(b, hq, hk, n, d, 12, torch.bfloat16)
    want, _ = ref.prefill_attention_ref(q, k, v)
    _, l_ = _noisy_model_out(q, k, v, torch.zeros((b, hq, n), dtype=bool),
                             0, 0)
    exact = l_ < flash_mod.EXACT_BELOW
    assert exact.any() and not exact.all()
    out, _ = _noisy_model_out(q, k, v, ~exact, 64, 13)
    d_out = (out - want).abs()
    assert (d_out > 1e-5).any()              # some probabilities flipped
    assert d_out.max() <= TC_OUT_ATOL
    out_all, _ = _noisy_model_out(q, k, v, torch.ones_like(exact), 64, 13)
    assert (out_all - want).abs().max() > TC_OUT_ATOL


@pytest.mark.parametrize("scale", [0.5, 1.0, 1.5])
def test_rows_past_exact_below_keep_probabilities_small(scale):
    """A row's largest probability is 1 / l, so in a row with l >=
    EXACT_BELOW every probability is at most 1/EXACT_BELOW, where one bf16
    ulp is at most 2^-13: a flip there moves out by 2^-13 |v| at most."""
    rng = np.random.default_rng(int(scale))
    s = torch.as_tensor(rng.standard_normal((512, 300)) * scale,
                        dtype=torch.float32)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    l_ = e.sum(-1)
    p = e / l_[:, None]
    far = l_ >= flash_mod.EXACT_BELOW
    assert far.any()
    assert torch.equal(p.amax(-1), 1 / l_)   # exp(0) / l
    pf = p[far]
    assert pf.max() <= 1 / flash_mod.EXACT_BELOW
    # the two bf16 neighbours of each probability that bf16 does not hold
    down = (pf.view(torch.int32) & -65536).view(torch.float32)
    pf, down = pf[down != pf], down[down != pf]
    up = torch.nextafter(down.to(torch.bfloat16), torch.tensor(
        1.0, dtype=torch.bfloat16)).float()
    assert ((down < pf) & (pf < up)).all()
    assert (up - down).max() <= 2.0 ** -13


# ---------------------------------------------------------------------------
# on a card: the kernel against its plain version
# ---------------------------------------------------------------------------


def _needs_card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")


@pytest.mark.gpu
@pytest.mark.parametrize("bh,g,n,d,dtype,ragged", [
    (8, 1, 256, 128, torch.float32, False),
    (8, 4, 200, 64, torch.float32, True),
    (4, 2, 130, 64, torch.bfloat16, False),
])
def test_flash_prefill_kernel_matches_plain_version_on_card(bh, g, n, d,
                                                            dtype, ragged):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(n)
    q, k, v = (torch.randn((rows, n, d), generator=gen, device="cuda").to(
        dtype) for rows in (bh, bh // g, bh // g))
    lengths = (torch.randint(1, n + 1, (bh,), generator=gen, device="cuda",
                             dtype=torch.int32) if ragged else None)
    before = flash_mod.LAUNCHES["flash_prefill"]
    out, acc = ops.flash_prefill(q, k, v, group=g, lengths=lengths)
    torch.cuda.synchronize()
    assert flash_mod.LAUNCHES["flash_prefill"] == before + 1
    want, want_acc = ref.flash_prefill_ref(q, k, v, group=g, lengths=lengths)
    assert out.dtype == dtype
    # a bf16 out is rounded on both sides: one bf16 ulp (2^-7 relative)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(out.float(), want.float(), rtol=rtol,
                               atol=1e-3)
    torch.testing.assert_close(acc, want_acc, rtol=1e-4, atol=1e-6)
    if lengths is not None:              # pad columns get exactly no mass
        cols = torch.arange(n, device="cuda")[None, :]
        assert not acc[cols >= lengths[:, None]].any()


@pytest.mark.gpu
@pytest.mark.parametrize("hq,hk,n,row0,c,obs,dtype", [
    (8, 8, 256, 0, 256, 0, torch.float32),
    (8, 2, 300, 64, 128, 16, torch.float32),
    (4, 4, 200, 0, 200, 0, torch.bfloat16),
])
def test_prefill_attention_kernel_matches_plain_version_on_card(
        hq, hk, n, row0, c, obs, dtype):
    _needs_card()
    b, d = 2, 64
    q, k, v = (x.cuda() for x in _model_inputs(b, hq, hk, n, d, n, dtype))
    q_c = q[:, :, row0:row0 + c]
    ln = torch.as_tensor([n - 3, row0 + c // 2], dtype=torch.int32,
                         device="cuda")
    acc0 = torch.rand((b, hk, n), device="cuda")
    acc = acc0.clone()
    before = flash_mod.LAUNCHES["flash_prefill"]
    out, acc = ops.prefill_attention(q_c, k, v, acc, row0=row0, length=ln,
                                     obs_window=obs)
    torch.cuda.synchronize()
    assert flash_mod.LAUNCHES["flash_prefill"] == before + 1
    want, col = ref.prefill_attention_ref(q_c, k, v, row0=row0, length=ln,
                                          obs_window=obs)
    # bf16 probabilities: one that sits within sum-order noise of a bf16
    # rounding boundary rounds the other way (one ulp, 2^-7 of it)
    bf16 = dtype == torch.bfloat16
    torch.testing.assert_close(out, want, rtol=0, atol=1e-2 if bf16 else 1e-3)
    torch.testing.assert_close(acc - acc0, col, rtol=2.0 ** -7 if bf16
                               else 1e-4, atol=1e-6)
    for bi in range(b):                  # columns past the length: no mass
        assert torch.equal(acc[bi, :, int(ln[bi]):], acc0[bi, :, int(ln[bi]):])


@pytest.mark.gpu
@pytest.mark.parametrize("model", [True, False])
def test_tc_route_matches_plain_version_on_card(model):
    """The bf16 (tensor-core) route at d = 128, ragged lengths and ragged
    N, GQA: the model contract through ops.prefill_attention, the TPU
    contract through ops.flash_prefill."""
    _needs_card()
    b, hq, hk, n, d = 2, 8, 2, 300, 128
    q, k, v = (x.cuda() for x in _model_inputs(b, hq, hk, n, d, 7,
                                                torch.bfloat16))
    ln = torch.as_tensor([n - 3, 141], dtype=torch.int32, device="cuda")
    before = flash_mod.LAUNCHES["flash_prefill"]
    if model:
        out, acc = ops.prefill_attention(q, k, v, length=ln, obs_window=0)
        want, want_acc = ref.prefill_attention_ref(q, k, v, length=ln)
        torch.testing.assert_close(out, want, rtol=0, atol=TC_OUT_ATOL)
        torch.testing.assert_close(acc, want_acc, rtol=TC_MODEL_ACC_RTOL,
                                   atol=0)
        lens = ln
    else:
        qf, kf, vf = (x.reshape(-1, n, d) for x in (q, k, v))
        lens = ln.repeat_interleave(hq)
        out, acc = ops.flash_prefill(qf, kf, vf, group=hq // hk,
                                     lengths=lens)
        want, want_acc = ref.flash_prefill_ref(qf, kf, vf, group=hq // hk,
                                               lengths=lens)
        assert out.dtype == torch.bfloat16
        torch.testing.assert_close(out.float(), want.float(), rtol=2.0 ** -7,
                                   atol=TC_OUT_ATOL)
        torch.testing.assert_close(acc, want_acc, rtol=TC_TPU_ACC_RTOL,
                                   atol=0)
        acc = acc[:, None]
    torch.cuda.synchronize()
    assert flash_mod.LAUNCHES["flash_prefill"] == before + 1
    for bi in range(len(lens)):          # pad columns get exactly no mass
        assert not acc[bi, :, int(lens[bi]):].any()


@pytest.mark.gpu
def test_tc_route_chunked_equals_whole_on_card():
    """4 chunks of 512 rows, their column sums added into one acc, give the
    whole 2048-row prompt's column sums and outputs bit for bit."""
    _needs_card()
    b, h, n, d, c = 1, 4, 2048, 128, 512
    q, k, v = (x.cuda() for x in _model_inputs(b, h, h, n, d, 11,
                                                torch.bfloat16))
    ln = torch.as_tensor([n - 7], dtype=torch.int32, device="cuda")
    acc_w = torch.zeros((b, h, n), device="cuda")
    out_w, _ = ops.prefill_attention(q, k, v, acc_w, length=ln)
    acc_c = torch.zeros_like(acc_w)
    outs = [ops.prefill_attention(q[:, :, r0:r0 + c], k, v, acc_c, row0=r0,
                                  length=ln)[0] for r0 in range(0, n, c)]
    torch.cuda.synchronize()
    assert torch.equal(acc_c, acc_w)
    assert torch.equal(torch.cat(outs, dim=2), out_w)


@pytest.mark.gpu
def test_exact_rows_change_only_their_rows_on_card():
    """Turning the exact rows off (EXACT_BELOW = 0) leaves every row whose
    denominator lies clearly above EXACT_BELOW bit for bit as it was: only
    the rows below it take the exact logits."""
    _needs_card()
    b, h, n, d = 1, 4, 512, 128
    q, k, v = (x.cuda() for x in _model_inputs(b, h, h, n, d, 13,
                                                torch.bfloat16))
    out, _ = ops.prefill_attention(q, k, v)
    below = flash_mod.EXACT_BELOW
    flash_mod.EXACT_BELOW = 0.0
    try:
        out_tc, _ = ops.prefill_attention(q, k, v)
    finally:
        flash_mod.EXACT_BELOW = below
    torch.cuda.synchronize()
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) / math.sqrt(d)
    causal = torch.ones((n, n), dtype=torch.bool, device="cuda").tril()
    s = s.masked_fill(~causal, NEG_INF)
    l_ = torch.exp(s - s.amax(-1, keepdim=True)).sum(-1)
    far = l_ > below * 1.01
    assert far.any() and (l_ < below * 0.99).any()
    assert torch.equal(out[far], out_tc[far])
