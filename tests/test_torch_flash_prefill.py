"""The port's prompt attention against the reference.

- `ref.flash_prefill_ref` (the TPU contract) against the reference's
  `flash_prefill` in interpret mode and its oracle, at the shapes, length
  mask and bf16 case of the reference's kernel tests, with their
  tolerances (out 2e-5, acc 2e-4 in f32; out 5e-2 in bf16);
- `ops.prefill_attention` on CPU tensors (the model's contract) against
  the reference's `chunked_causal_attention` (row0 = 0) and
  `prefill_chunk_attend` (row0 > 0 into a longer buffer), 1e-5;
- a blocked emulation of the CUDA kernel's tiling (64-row query blocks,
  64-column K tiles, masked tiles skipped, two passes, per-block column
  partials folded in order): held to the plain version at 1e-5, ragged N
  included, and its chunked use (row0 a multiple of the block, acc
  accumulated in place) equal to its whole-prompt use bit for bit. It
  holds the kernel's algorithm, though not its CUDA code, to the contract;
- on a card only, the kernel against its plain version, both contracts.
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


def emulate_kernel(q, k, v, lengths, acc, *, group, acc_group, row0=0,
                   obs_window=0, round_p=False, scale=None):
    """The kernel pair of `csrc/flash_prefill.cu`, tile for tile: q [BH,C,d],
    k/v [BH/group,N,d], lengths [BH], acc [BH/acc_group,N] (+= in place) →
    out [BH,C,d] f32."""
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
        for kt in range(ntiles):                       # pass 1
            s, _, _ = tile(kt)
            m_new = torch.maximum(m, s.amax(-1))
            l_ = l_ * torch.exp(m - m_new) + torch.exp(
                s - m_new[..., None]).sum(-1)
            m = m_new
        den = torch.clamp(l_, min=1e-30)
        o = torch.zeros((bh, BQ, d))
        for kt in range(ntiles):                       # pass 2
            s, vt_, nv = tile(kt)
            p = torch.exp(s - m[..., None]) / den[..., None]
            if round_p:
                p = p.to(torch.bfloat16).float()
            cs = torch.zeros((bh, BK))
            for r in range(BQ):                        # row order
                cs = cs + p[:, r] * counts[:, r, None].float()
            part[:, qb, kt * BK:kt * BK + nv] = cs[:, :nv]
            o = o + torch.matmul(p, vt_)
        out[:, r_lo:r_lo + rows] = o[:, :rows]
    # the fold: q-block order, then the summed q-heads in head order
    parts = part.reshape(bh // acc_group, acc_group, nqb, n)
    for qb in range(nqb):
        reach = ((row0 + min((qb + 1) * BQ, c) - 1) // BK + 1) * BK
        for g in range(acc_group):
            acc[:, :reach] += parts[:, g, qb, :reach]
    return out


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
