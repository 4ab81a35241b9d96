"""MLA training in the port against the reference: the attention backward
at the latent width, `mla_train`, and the latent route of the
`flash_prefill_bwd` kernel.

- `ref.flash_prefill_bwd_ref` at MLA's true latent width (d = 576, dv =
  512, 4 q-heads over one latent, V the view of its first 512 columns),
  against `jax.vjp` of the reference's `chunked_causal_attention(q,
  u[:, None], u[:, None, :, :512])`: with respect to q, K and V apart
  (f32 within 1e-5, bf16 within `_bound` of
  `tests/test_torch_attention_grad.py`), and the same gradients through
  `ops.causal_attention`, autograd adding K's and V's into the latent's
  (bf16: each of the two within its `_bound`, plus half a bf16 ulp of the
  sum: 2^-8 max|du|);
- the latent route's algorithm emulated in PyTorch (`emulate_latent`): an
  f32 dout split once into bf16 hi + lo; 64-row q-blocks over latent tiles
  of 32 keys (16 with an f32 dout) with the online statistics; the
  latent's gradient du over 64-key blocks and q tiles of as many rows, dS^T
  q and T(P)^T dout in one f32 sum, each slice of q-heads summed apart and
  the slices added in order; dS as bf16 hi + lo), against the plain
  version (du: its dk + [dv, 0] summed in f32 and rounded once,
  `ref.latent_du`), to `_assert_kernel_close`, also on a latent whose rows
  share a large common vector;
- u's gradient through `ops.causal_attention` bit for bit the same whether
  the backward returns (du, None) or the plain (dk, dv); the refusal of a
  V that is not K's view; `ref.split_bf16_ref`;
- `mla_train` against the reference's at reduced deepseek-v3 (latent 40,
  4 heads), its out and the gradients of x and every weight, f32, 1e-5
  relative to each tensor's largest value;
- the wrapper's refusals before a launch (an f32 latent, more than one
  latent) and its head slices;
- `ref.flash_prefill_bwd_dq_flip` bounds what one dP element rounding to
  its other bf16 neighbour does to dq, every (row, key) of a small case in
  both directions;
- on a card only (`-m gpu`): the latent route against its plain version
  at Hq 4 to 128 and ragged N, with an f32 and a bf16 dout (du to
  `_assert_kernel_close`, dq to that plus the flip bound: the kernel sums
  dout · v in another order, so it may round a dP element near a
  rounding midpoint the other way, which on a row where dP - D cancels
  moves dq by up to the row's size), two launches bit-equal, one count a
  backward, its refusal of a V that is not the view of K, and the dout
  split bit for bit against `ref.split_bf16_ref`.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import flash_prefill_bwd as bwd_mod
from repro_torch.kernels import ops, ref
from repro_torch.models import mla

from test_torch_attention_grad import _assert_kernel_close, _bound

D, DV = 576, 512
SCALE = 192 ** -0.5                 # deepseek-v3's 1/sqrt(qk_nope + rope)


def _jax():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platform_name", "cpu")
    import jax.numpy as jnp
    from repro.core.attention import chunked_causal_attention
    return jax, jnp, chunked_causal_attention


def _latent_inputs(b, hq, n, seed, q_scale=1.0):
    """q [B,Hq,N,576], the latent u [B,N,576], dout [B,Hq,N,512], f32."""
    rng = np.random.default_rng(seed)
    return (q_scale * rng.standard_normal((b, hq, n, D)).astype(np.float32),
            rng.standard_normal((b, n, D)).astype(np.float32),
            rng.standard_normal((b, hq, n, DV)).astype(np.float32))


def _views(u):
    return u[:, None], u[:, None, :, :DV]


def _reference_vjp(q, u, dout, dtype, chunk, wrt_latent):
    """jax.vjp of the reference's out over the latent → the gradients (of
    q, K and V, or of q and u) as f32 numpy."""
    jax, jnp, cca = _jax()
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    qj, uj = jnp.asarray(q).astype(jd), jnp.asarray(u).astype(jd)
    if wrt_latent:
        _, vjp = jax.vjp(lambda a, c: cca(a, c[:, None], c[:, None, :, :DV],
                                          chunk=chunk, scale=SCALE)[0],
                         qj, uj)
    else:
        _, vjp = jax.vjp(lambda a, k, v: cca(a, k, v, chunk=chunk,
                                             scale=SCALE)[0],
                         qj, uj[:, None], uj[:, None, :, :DV])
    grads = vjp(jnp.asarray(dout))
    return [np.asarray(x.astype(jnp.float32)) for x in grads]


def _err(a, w):
    return float(np.abs(a.float().numpy() - w).max())


LATENT_CASES = [(dt, n, chunk) for dt in (torch.float32, torch.bfloat16)
                for n, chunk in ((96, 96), (150, 64))]


@pytest.mark.parametrize("dtype,n,chunk", LATENT_CASES)
def test_plain_backward_at_latent_width_matches_reference_vjp(dtype, n,
                                                              chunk):
    q, u, dout = _latent_inputs(1, 4, n, seed=n)
    want = _reference_vjp(q, u, dout, dtype, chunk, wrt_latent=False)
    tu = torch.from_numpy(u).to(dtype)
    got = ref.flash_prefill_bwd_ref(torch.from_numpy(q).to(dtype),
                                    *_views(tu), torch.from_numpy(dout),
                                    scale=SCALE, chunk=chunk)
    for name, a, w in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dtype
        assert _err(a, w) <= _bound(dtype, n, chunk, np.abs(w).max()), name


@pytest.mark.parametrize("dtype,n,chunk", LATENT_CASES)
def test_causal_attention_latent_gradient_matches_reference(dtype, n,
                                                            chunk):
    """`ops.causal_attention` over K = u and V = u[..., :512] (the call
    `mla_train` makes): autograd adds the two gradients into u's."""
    q, u, dout = _latent_inputs(1, 4, n, seed=n + 1)
    want_q, want_u = _reference_vjp(q, u, dout, dtype, chunk,
                                    wrt_latent=True)
    parts = _reference_vjp(q, u, dout, dtype, chunk, wrt_latent=False)
    tq = torch.from_numpy(q).to(dtype).requires_grad_(True)
    tu = torch.from_numpy(u).to(dtype).requires_grad_(True)
    before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
    out = ops.causal_attention(tq, *_views(tu), scale=SCALE, chunk=chunk)
    assert out.shape == (1, 4, n, DV) and out.dtype == torch.float32
    out.backward(torch.from_numpy(dout))
    assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before
    assert _err(tq.grad, want_q) <= _bound(dtype, n, chunk,
                                           np.abs(want_q).max())
    tol = (1e-5 if dtype == torch.float32 else
           sum(_bound(dtype, n, chunk, np.abs(w).max()) for w in parts[1:])
           + 2.0 ** -8 * np.abs(want_u).max())
    assert _err(tu.grad, want_u) <= tol


def emulate_latent(q, u, dout, scale, slices=None):
    """The latent route of the `flash_prefill_bwd` kernel in PyTorch: q
    [B,Hq,N,576] and the latent u [B,N,576] bf16, dout [B,Hq,N,512] f32 or
    bf16 → (dq, du [B,1,N,576]) bf16, du the latent's gradient through K
    and V.

    An f32 dout is split first into bf16 hi and lo (the split pass); the
    kernels take it as the operand hi + lo. dq kernel: per 64-row q-block,
    latent tiles of T keys (32 with a bf16 dout, 16 with an f32 one) up to
    the block's last row (and N); logits in
    base-2 units (scale log2(e)) masked past the row, past N and on rows
    past N; sweep 1 carries m, l and sum exp2(s - m) (dP - dP_i0) online, D
    = dP_i0 + that sum / max(l, 1e-30); sweep 2 makes P = exp2(s - m) /
    max(l, 1e-30) and dS = P (dP - D) scale and adds dS k, dS as bf16 hi +
    lo. du kernel: per 64-key block and slice of q-heads
    (`bwd_mod.latent_slices`, or `slices`), the heads in order, then the
    q tiles of T rows at or after the block; du += dS^T q (hi + lo) +
    [T(P)^T dout, 0] in one f32 sum, the slice's partial; the partials
    added in slice order and rounded once. dP = T(dout v) throughout;
    products in f32."""
    b, hq, n, _ = q.shape
    slices = slices or bwd_mod.latent_slices(hq)
    tt = 32 if dout.dtype == torch.bfloat16 else 16
    hs = hq // slices
    sl = torch.tensor(scale, dtype=torch.float32) * torch.tensor(
        math.log2(math.e), dtype=torch.float32)
    neg = torch.tensor(-1e30)

    def split(x):                       # x as bf16 hi + lo, in f32
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float()

    qf, kf = q.float(), u.float()[:, None]
    vf = kf[..., :DV]
    do = dout.float() if dout.dtype == torch.bfloat16 else split(dout)

    def mask(rows, cols):               # [rows, cols]: live logits
        return ((cols[None, :] <= rows[:, None]) & (cols[None, :] < n)
                & (rows[:, None] < n))

    def tile(x, idx):                   # rows idx of x [.., N, w], 0 past N
        ok = idx < n
        out = x[..., idx.clamp(max=n - 1), :]
        return torch.where(ok[:, None], out, torch.zeros(()))

    dq = torch.zeros_like(qf)
    stats = torch.zeros((3, b, hq, n))
    nqb = -(-n // 64)
    for qb in range(nqb):
        rows = qb * 64 + torch.arange(64)
        qt, dt = tile(qf, rows), tile(do, rows)
        ntiles = min((qb + 1) * (64 // tt), -(-n // tt))
        m = torch.full((b, hq, 64), -1e30)
        l_ = torch.zeros((b, hq, 64))
        dn = torch.zeros((b, hq, 64))
        c = torch.zeros((b, hq, 64))

        def scores(kt):
            cols = kt * tt + torch.arange(tt)
            kk, vv = tile(kf, cols), tile(vf, cols)
            s = torch.where(mask(rows, cols),
                            (qt @ kk.transpose(-1, -2)) * sl, neg)
            dp = (dt @ vv.transpose(-1, -2)).to(torch.bfloat16).float()
            return s, dp, kk

        for kt in range(ntiles):
            s, dp, _ = scores(kt)
            if kt == 0:
                c = dp[..., 0]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp2(m - m_new)
            e = torch.exp2(s - m_new[..., None])
            l_ = l_ * alpha + e.sum(-1)
            dn = dn * alpha + (e * (dp - c[..., None])).sum(-1)
            m = m_new
        lc = torch.clamp(l_, min=1e-30)
        rl, dd = 1 / lc, c + dn / lc
        live = rows < n
        stats[..., rows[live]] = torch.stack((m, rl, dd))[..., live]
        for kt in range(ntiles):
            s, dp, kk = scores(kt)
            p = torch.exp2(s - m[..., None]) * rl[..., None]
            ds = p * (dp - dd[..., None]) * scale
            dq[..., rows[live], :] += (split(ds) @ kk)[..., live, :]
    part = torch.zeros((slices, b, n, D))
    for kb in range(nqb):
        cols = kb * 64 + torch.arange(64)
        kk, vv = tile(kf[:, 0], cols), tile(vf[:, 0], cols)
        live_k = cols < n
        for sc in range(slices):
            gu = torch.zeros((b, 64, D))
            for h in range(sc * hs, (sc + 1) * hs):
                for r0 in range(kb * 64 // tt * tt, -(-n // tt) * tt, tt):
                    rows = r0 + torch.arange(tt)
                    ok = rows < n
                    m, rl, dd = (torch.where(ok, x[:, h][:, rows.clamp(
                        max=n - 1)], torch.zeros(())) for x in stats)
                    qt, dt = tile(qf[:, h], rows), tile(do[:, h], rows)
                    st = torch.where(mask(rows, cols).T,
                                     (kk @ qt.transpose(-1, -2)) * sl, neg)
                    p = torch.exp2(st - m[:, None, :]) * rl[:, None, :]
                    dp = (vv @ dt.transpose(-1, -2)).to(
                        torch.bfloat16).float()
                    ds = p * (dp - dd[:, None, :]) * scale
                    gu += split(ds) @ qt
                    gu[..., :DV] += p.to(torch.bfloat16).float() @ dt
            part[sc, :, cols[live_k]] = gu[:, live_k]
    du = part[0]
    for sc in range(1, slices):
        du = du + part[sc]
    return dq.to(torch.bfloat16), du[:, None].to(torch.bfloat16)


def _plain_latent(q, u, dout):
    """The plain version's (dq, du) on the same inputs."""
    dq, dk, dv = ref.flash_prefill_bwd_ref(q, *_views(u), dout, scale=SCALE)
    return dq, ref.latent_du(dk, dv)


@pytest.mark.parametrize("hq,n,dout_dtype,slices", [
    (4, 150, torch.float32, None), (4, 96, torch.bfloat16, None),
    (6, 70, torch.float32, 3), (2, 129, torch.bfloat16, 2),
    (3, 161, torch.bfloat16, 1), (2, 83, torch.float32, 1)])
def test_latent_route_algorithm_matches_plain_version(hq, n, dout_dtype,
                                                      slices):
    """The latent route's blocking (latent tiles of 32 keys with a bf16
    dout, 16 with an f32 one, against 64-row q-blocks; q tiles of as many
    rows against 64-key blocks; the ragged last block and tile; q-head
    slices summed apart and added in order, one slice among them) and its
    roundings (dS and the pre-split f32 dout as bf16 hi + lo, du summed
    through K and V in f32 and rounded once), against the plain version on
    the same bf16 inputs (du: `ref.latent_du`), to `_assert_kernel_close`."""
    q, u, dout = (torch.from_numpy(x) for x in
                  _latent_inputs(1, hq, n, seed=hq * 1000 + n))
    q, u = q.to(torch.bfloat16), u.to(torch.bfloat16)
    dout = dout.to(dout_dtype)
    got = emulate_latent(q, u, dout, SCALE, slices)
    want = _plain_latent(q, u, dout)
    for a, w in zip(got, want):
        assert a.shape == w.shape
        _assert_kernel_close(a, w)


def test_latent_route_algorithm_holds_a_latent_with_a_common_component():
    """Latent rows that share a large common vector (u_j = c + delta_j, |c|
    about 8 |delta|, as a model's normed latents do): sum_j dS_ij = 0
    cancels c out of dq and du only as far as the products keep dS, which
    the route's hi + lo operands keep to 2^-16 (dS rounded to bf16 alone
    misses `_assert_kernel_close` here)."""
    rng = np.random.default_rng(17)
    hq, n = 4, 100
    q = 0.3 * rng.standard_normal((1, hq, n, D))
    u = (4 + rng.standard_normal((1, 1, D))
         + 0.5 * rng.standard_normal((1, n, D)))
    dout = rng.standard_normal((1, hq, n, DV))
    q, u = (torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
            for x in (q, u))
    dout = torch.from_numpy(dout.astype(np.float32))
    got = emulate_latent(q, u, dout, SCALE)
    want = _plain_latent(q, u, dout)
    for a, w in zip(got, want):
        _assert_kernel_close(a, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_latent_gradient_as_du_equals_the_views_sum(dtype, monkeypatch):
    """u's gradient through `ops.causal_attention` at the latent shape is
    the same tensor, bit for bit, whether the backward returns (du, None),
    as it does, or the plain (dk, dv), which autograd adds through the two
    views; q's too."""
    q, u, dout = _latent_inputs(1, 4, 70, seed=9)

    def grads():
        tq = torch.from_numpy(q).to(dtype).requires_grad_(True)
        tu = torch.from_numpy(u).to(dtype).requires_grad_(True)
        out = ops.causal_attention(tq, *_views(tu), scale=SCALE, chunk=32)
        out.backward(torch.from_numpy(dout))
        return tq.grad, tu.grad

    as_du = grads()
    monkeypatch.setattr(
        ops, "prefill_attention_bwd",
        lambda q, k, v, dout, scale=None, chunk=512:
        ref.flash_prefill_bwd_ref(q, k, v, dout, scale=scale, chunk=chunk))
    as_views = grads()
    assert as_du[1].dtype == dtype
    assert torch.equal(as_du[0], as_views[0])
    assert torch.equal(as_du[1], as_views[1])


def test_latent_backward_refuses_a_v_that_is_not_the_view():
    """The latent shape's backward returns the latent's whole gradient, so
    `ops.prefill_attention_bwd` refuses a V that is not the view of K's
    first 512 columns, on the CPU as the wrapper does on the card."""
    q, u, dout = (torch.from_numpy(x) for x in _latent_inputs(1, 2, 8, 0))
    k, v = _views(u)
    with pytest.raises(ValueError, match="view"):
        ops.prefill_attention_bwd(q, k, v.contiguous(), dout, scale=SCALE)
    dq, du, none = ops.prefill_attention_bwd(q, k, v, dout, scale=SCALE)
    assert none is None and du.shape == k.shape


def test_split_bf16_ref_keeps_dout_to_2_to_the_minus_16():
    """`ref.split_bf16_ref`, the plain version of the route's dout split:
    hi is dout rounded to bf16, lo what is left rounded again, hi + lo
    within 2^-16 relative of dout (one ulp of lo at most), zeros and
    signs kept."""
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (3, 512)).astype(np.float32))
    x[0, :3] = torch.tensor([0.0, -0.0, 1.0 + 2 ** -9])
    hi, lo = ref.split_bf16_ref(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert torch.equal(hi, x.to(torch.bfloat16))
    assert torch.equal(lo, (x - hi.float()).to(torch.bfloat16))
    err = (hi.float() + lo.float() - x).abs()
    assert bool((err <= 2.0 ** -16 * x.abs()).all())
    assert torch.equal(torch.signbit(hi[0, :2]), torch.signbit(x[0, :2]))


def test_latent_slices_cover_the_heads():
    for hq, want in ((1, 1), (4, 1), (16, 1), (32, 2), (48, 3), (128, 8),
                     (6, 1), (18, 2)):
        s = bwd_mod.latent_slices(hq)
        assert s == want and hq % s == 0 and hq // s <= 16


def _mla_params(cfg, rng):
    m, h, d = cfg.mla, cfg.n_heads, cfg.d_model
    shapes = {"wq_a": (d, m.q_lora_rank), "q_norm": (m.q_lora_rank,),
              "wq_b": (m.q_lora_rank, h * (m.qk_nope_dim + m.qk_rope_dim)),
              "wkv_a": (d, m.kv_lora_rank + m.qk_rope_dim),
              "kv_norm": (m.kv_lora_rank,),
              "wkv_b": (m.kv_lora_rank, h * (m.qk_nope_dim + m.v_dim)),
              "wo": (h * m.v_dim, d)}
    return {k: ((1 + 0.1 * rng.standard_normal(s)) if len(s) == 1 else
                rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
            for k, s in shapes.items()}


def test_mla_train_matches_reference_with_weight_gradients():
    """`mla_train` at reduced deepseek-v3 (latent 32 + 8, 4 heads, chunk 16
    over 37 rows) against the reference's: out and the gradients of x and
    of every weight (the norms noised around one), f32, each within 1e-5
    of its tensor's largest value."""
    jax, jnp, _ = _jax()
    from repro.configs.base import get_config as jget, reduced as jreduced
    from repro.models.mla import mla_train as jmla_train
    jcfg = jreduced(jget("deepseek-v3-671b"))
    cfg = reduced(get_config("deepseek-v3-671b"))
    rng = np.random.default_rng(21)
    b, t = 2, 37
    p = _mla_params(cfg, rng)
    x = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal((b, t, cfg.d_model)).astype(np.float32)
    pos = np.arange(t)[None]
    y, vjp = jax.vjp(lambda pj, xj: jmla_train(pj, xj, jcfg,
                                               jnp.asarray(pos), chunk=16),
                     {k: jnp.asarray(a) for k, a in p.items()},
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    tp = {k: torch.from_numpy(a).requires_grad_(True) for k, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = mla.mla_train(tp, tx, cfg, torch.from_numpy(pos), chunk=16)
    ty.backward(torch.from_numpy(dy))
    for name, a, w in [("out", ty.detach(), y), ("x", tx.grad, gx)] + [
            (k, tp[k].grad, gp[k]) for k in p]:
        w = np.asarray(w)
        np.testing.assert_allclose(a.numpy(), w, rtol=0,
                                   atol=1e-5 * np.abs(w).max(), err_msg=name)


def test_latent_wrapper_refusals_before_a_launch():
    """The latent route takes bf16 over one latent: an f32 latent raises
    TypeError and Hk > 1 ValueError, before any device check, and nothing
    is counted."""
    q, u, dout = (torch.from_numpy(x) for x in _latent_inputs(1, 2, 8, 0))
    before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
    with pytest.raises(TypeError, match="latent route"):
        bwd_mod.flash_prefill_bwd(q, *_views(u), dout, SCALE)
    ub = u.to(torch.bfloat16)
    k2 = torch.cat([ub[:, None]] * 2, dim=1)
    with pytest.raises(ValueError, match="Hk = 2"):
        bwd_mod.flash_prefill_bwd(q.to(torch.bfloat16), k2, k2[..., :DV],
                                  dout, SCALE)
    with pytest.raises(ValueError, match="CUDA"):
        bwd_mod.flash_prefill_bwd(q.to(torch.bfloat16), *_views(ub), dout,
                                  SCALE)
    assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before


def test_dq_flip_bound_covers_one_rounding_flip():
    """For every row i and key j <= i of a small bf16 case, dq_i made with
    dP_ij moved to either bf16 neighbour (its bits plus or minus one) stays
    within `ref.flash_prefill_bwd_dq_flip`'s bound of dq_i (f32 throughout,
    dq unrounded; 1e-6 for the f32 sums' order); an f32 V gives zeros."""
    rng = np.random.default_rng(5)
    b, hq, n, d = 1, 2, 7, 16
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(s).astype(
        np.float32)) for s in ((b, hq, n, d), (b, 1, n, d), (b, 1, n, d),
                               (b, hq, n, d)))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    scale = d ** -0.5
    bound = ref.flash_prefill_bwd_dq_flip(q, k, v, dout, scale=scale)
    kf = k.float()[:, 0]
    s_ = (q.float() @ kf.transpose(-1, -2)) * scale
    causal = torch.ones((n, n), dtype=torch.bool).tril()
    p = torch.softmax(torch.where(causal, s_, torch.tensor(-1e30)), -1)
    dp = (dout @ v.float()[:, 0].transpose(-1, -2)).to(torch.bfloat16)

    def dq_of(dpf):
        dd = (p * dpf).sum(-1, keepdim=True)
        return (p * (dpf - dd) * scale) @ kf

    base = dq_of(dp.float())
    bits = dp.view(torch.int16)
    for i in range(n):
        for j in range(i + 1):
            for step in (-1, 1):
                moved = bits.clone()
                moved[..., i, j] += step
                got = dq_of(moved.view(torch.bfloat16).float())
                err = (got - base).abs()[..., i, :]
                assert bool((err <= bound[..., i, :] + 1e-6).all()), (i, j)
    assert not ref.flash_prefill_bwd_dq_flip(
        q.float(), k.float(), v.float(), dout).any()


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _needs_card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,n", [(1, 4, 150), (2, 32, 300),
                                    (1, 128, 200)])
def test_latent_backward_kernel_matches_plain_version_on_card(b, hq, n):
    """The latent route with an f32 and a bf16 dout against the plain
    version at ragged N, q at half the latent's scale: du (the latent's
    gradient) within `_assert_kernel_close` of the plain dk + [dv, 0]
    (`ref.latent_du`), dq within that plus the flip bound, two launches
    bit-equal, one count a backward."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(hq + n)
    u = torch.randn((b, n, D), generator=gen, device="cuda").to(
        torch.bfloat16)
    q = (0.5 * torch.randn((b, hq, n, D), generator=gen, device="cuda")).to(
        torch.bfloat16)
    dout = torch.randn((b, hq, n, DV), generator=gen, device="cuda")
    for cot in (dout, dout.to(torch.bfloat16)):
        before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
        got = ops.prefill_attention_bwd(q, *_views(u), cot, scale=SCALE)
        again = ops.prefill_attention_bwd(q, *_views(u), cot, scale=SCALE)
        torch.cuda.synchronize()
        assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before + 2
        assert got[2] is None and again[2] is None
        want = _plain_latent(q, u, cot)
        flip = ref.flash_prefill_bwd_dq_flip(q, *_views(u), cot,
                                             scale=SCALE)
        for a, a2, w in zip(got[:2], again[:2], want):
            assert a.dtype == torch.bfloat16 and a.shape == w.shape
            assert torch.equal(a, a2)
        _assert_kernel_close(got[1], want[1])
        diff = (got[0].float() - want[0].float()).abs()
        mag = want[0].float().abs()
        limit = 2.0 ** -7 * (mag + mag.amax(-1, keepdim=True)) + flip
        assert bool((diff <= limit).all()), float((diff - limit).max())


@pytest.mark.gpu
def test_latent_dout_split_matches_plain_split_on_card():
    """The route's split pass (`bwd_mod.split_dout`) against
    `ref.split_bf16_ref`, bit for bit, on `ref.split_bf16_cases`: values
    over 60 binades, zeros of both signs, subnormals and the f32
    extremes."""
    _needs_card()
    x = ref.split_bf16_cases((2, 4, 64, DV),
                             torch.Generator(device="cuda").manual_seed(3))
    got = bwd_mod.split_dout(x)
    want = ref.split_bf16_ref(x)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.gpu
def test_latent_backward_kernel_refuses_a_copied_v_on_card():
    _needs_card()
    u = torch.zeros((1, 64, D), device="cuda", dtype=torch.bfloat16)
    q = torch.zeros((1, 4, 64, D), device="cuda", dtype=torch.bfloat16)
    dout = torch.zeros((1, 4, 64, DV), device="cuda")
    k, v = _views(u)
    with pytest.raises(ValueError, match="view"):
        bwd_mod.flash_prefill_bwd(q, k, v.contiguous(), dout, SCALE)
