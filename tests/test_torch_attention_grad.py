"""The gradient of the port's causal prompt attention against the
reference's autodiff.

The reference trains through `jax.vjp` of `chunked_causal_attention`
(plain XLA); the port's training attention is `ops.causal_attention`, a
`torch.autograd.Function` whose backward is the `flash_prefill_bwd`
kernel on the card and `ref.flash_prefill_bwd_ref` on the CPU.

- `ref.flash_prefill_bwd_ref`, and the gradient of `ops.causal_attention`
  through autograd, against `jax.vjp` of the reference's
  `chunked_causal_attention`: f32 and bf16, GQA groups 1, 2 and 4, N not
  a multiple of `chunk` (three chunks) and N within one chunk.
  Tolerances: f32 within 1e-5 (both sides sum the same f32 products in
  other orders). bf16: both sides round dP, dq, dk and dv to bf16 from
  f32 sums taken in other orders, so an element may land one bf16 ulp
  (up to 2^-7 of it) apart (and out by a probability's one-ulp flip,
  2^-8 |v| at most); over C > 1 chunks the reference also rounds
  each chunk's dk and dv to bf16 and adds those partials in bf16 (2C - 1
  more roundings, each within 2^-9 of a partial or running sum that
  stays within twice the final largest gradient). So the bound is
  (2C - 1) · 2^-8 · max|grad| (one chunk: 2^-8 · max|grad|, one ulp of
  values below half the largest).
- `ops.causal_attention(..., out_dtype=bf16)`, the model's call, against
  `jax.vjp` of the reference's `chunked_causal_attention(...)[0]
  .astype(bf16)`: the forward and the gradients from a bf16 cotangent.
- the kernels' blocked algorithm, emulated in PyTorch (online row
  statistics, ragged N, dk/dv in head then q-tile order; on bf16 inputs
  the wgmma route's roundings: dS as bf16 hi + lo, a bf16 dout as it
  is, an f32 dout as bf16 hi + lo; keys with a common component, a
  zero-gradient row), against the plain version: f32 1e-5,
  bf16 each element within one bf16 ulp of itself plus one of the
  largest gradient of its row;
- `attention_train` (the block's attention sublayer, causal and not)
  against the reference's, with the gradients of every projection, f32.
- the kernel wrapper's refusals on the CPU (dtypes, dout f32 or bf16
  only, head dims past the GQA route's; MLA's latent shape goes to its own
  route, `tests/test_torch_mla_train.py`) and the launch counter.
- on a card only (`-m gpu`): the kernel against its plain version at
  bf16 and f32, GQA and d = 16 … 128, a bf16 and an f32 dout on the bf16
  route, two launches bit-equal, one count a backward.
"""
from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.kernels import flash_prefill_bwd as bwd_mod
from repro_torch.kernels import ops, ref
from repro_torch.models import attention_layer as al


def _jax():
    jax = pytest.importorskip("jax")
    jax.config.update("jax_platform_name", "cpu")
    import jax.numpy as jnp
    from repro.core.attention import chunked_causal_attention
    return jax, jnp, chunked_causal_attention


def _inputs(b, hq, hk, n, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32) for s in
            ((b, hq, n, d), (b, hk, n, d), (b, hk, n, d), (b, hq, n, d))]


def _reference_vjp(q, k, v, dout, dtype, chunk):
    """jax.vjp of the reference's out → (out f32, dq, dk, dv) as f32 numpy."""
    jax, jnp, cca = _jax()
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    args = [jnp.asarray(x).astype(jd) for x in (q, k, v)]
    out, vjp = jax.vjp(lambda a, b_, c: cca(a, b_, c, chunk=chunk)[0],
                       *args)
    grads = vjp(jnp.asarray(dout).astype(out.dtype))
    return [np.asarray(x.astype(jnp.float32)) for x in (out, *grads)]


def _bound(dtype, n, chunk, top):
    if dtype == torch.float32:
        return 1e-5
    n_chunks = -(-n // min(chunk, n))
    return (2 * n_chunks - 1) * 2.0 ** -8 * top


CASES = [(dt, g, n, chunk) for dt in (torch.float32, torch.bfloat16)
         for g in (1, 2, 4) for n, chunk in ((45, 16), (40, 64))]


@pytest.mark.parametrize("dtype,g,n,chunk", CASES)
def test_plain_backward_matches_reference_vjp(dtype, g, n, chunk):
    q, k, v, dout = _inputs(2, 2 * g, 2, n, 16, seed=g * 100 + n)
    want = _reference_vjp(q, k, v, dout, dtype, chunk)
    got = ref.flash_prefill_bwd_ref(
        *(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
        torch.from_numpy(dout), chunk=chunk)
    for name, a, w in zip(("dq", "dk", "dv"), got, want[1:]):
        assert a.dtype == dtype
        err = np.abs(a.float().numpy() - w).max()
        assert err <= _bound(dtype, n, chunk, np.abs(w).max()), (name, err)


@pytest.mark.parametrize("dtype,g", [(dt, g) for dt in (torch.float32,
                                                        torch.bfloat16)
                                     for g in (1, 2, 4)])
def test_causal_attention_op_gradient_matches_reference(dtype, g):
    n, chunk = 45, 16
    q, k, v, dout = _inputs(2, 2 * g, 2, n, 16, seed=7 + g)
    want = _reference_vjp(q, k, v, dout, dtype, chunk)
    leaves = [torch.from_numpy(x).to(dtype).requires_grad_(True)
              for x in (q, k, v)]
    before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
    out = ops.causal_attention(*leaves, chunk=chunk)
    assert out.dtype == torch.float32
    # bf16: a probability within sum-order noise of a bf16 rounding
    # boundary rounds the other way on one side, moving out by one bf16
    # ulp of p (at most 2^-8) times |v|
    out_tol = 1e-5 if dtype == torch.float32 else 2.0 ** -8 * np.abs(v).max()
    np.testing.assert_allclose(out.detach().numpy(), want[0], atol=out_tol)
    out.backward(torch.from_numpy(dout))
    assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before   # plain on CPU
    for leaf, w in zip(leaves, want[1:]):
        err = np.abs(leaf.grad.float().numpy() - w).max()
        assert err <= _bound(dtype, n, chunk, np.abs(w).max()), err


def test_causal_attention_scale_and_chunk_reach_the_backward():
    """A scale other than 1/sqrt(d) and the chunk pass through to both
    passes: the gradient equals the plain backward's at that scale."""
    q, k, v, dout = _inputs(1, 4, 2, 33, 16, seed=3)
    leaves = [torch.from_numpy(x).requires_grad_(True) for x in (q, k, v)]
    ops.causal_attention(*leaves, scale=0.3, chunk=8).backward(
        torch.from_numpy(dout))
    want = ref.flash_prefill_bwd_ref(
        *(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(dout),
        scale=0.3, chunk=8)
    for leaf, w in zip(leaves, want):
        torch.testing.assert_close(leaf.grad, w, rtol=0, atol=1e-6)


@pytest.mark.parametrize("causal", [True, False])
def test_attention_train_matches_reference_with_weight_gradients(causal):
    jax, jnp, _ = _jax()
    from repro.configs.base import get_config as jget, reduced as jreduced
    from repro.models.attention_layer import attention_train as jat
    arch = "granite-3-2b" if causal else "whisper-base"
    jcfg, cfg = jreduced(jget(arch)), reduced(get_config(arch))
    rng = np.random.default_rng(11)
    b, t, d = 2, 37, cfg.d_model
    shapes = {"wq": (d, cfg.q_dim), "wk": (d, cfg.kv_dim),
              "wv": (d, cfg.kv_dim), "wo": (cfg.q_dim, d)}
    if cfg.qkv_bias:
        shapes.update(bq=(cfg.q_dim,), bk=(cfg.kv_dim,), bv=(cfg.kv_dim,))
    p = {k: (rng.standard_normal(s) / np.sqrt(s[0])).astype(np.float32)
         for k, s in shapes.items()}
    x = rng.standard_normal((b, t, d)).astype(np.float32)
    dy = rng.standard_normal((b, t, d)).astype(np.float32)
    pos = np.arange(t)[None]

    def jf(pj, xj):
        return jat(pj, xj, jcfg, jnp.asarray(pos), causal=causal, chunk=16)
    y, vjp = jax.vjp(jf, {k: jnp.asarray(a) for k, a in p.items()},
                     jnp.asarray(x))
    gp, gx = vjp(jnp.asarray(dy))
    tp = {k: torch.from_numpy(a).requires_grad_(True) for k, a in p.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    ty = al.attention_train(tp, tx, cfg, torch.from_numpy(pos),
                            causal=causal, chunk=16)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y),
                               atol=1e-5)
    ty.backward(torch.from_numpy(dy))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-5)
    for k in p:
        np.testing.assert_allclose(tp[k].grad.numpy(), np.asarray(gp[k]),
                                   atol=1e-5, err_msg=k)


def _emulate_kernel(q, k, v, dout, scale, blk=64):
    """The `flash_prefill_bwd` kernels' algorithm in PyTorch: 64-row
    q-blocks over 64-key tiles up to the diagonal, zero-padded past N and
    masked there; the dq kernel's sweep 1 carries m, l and sum exp(s - m)
    dP online (rescaled as the max grows), sweep 2 makes dS and dq from
    them; the dk/dv kernel recomputes P and dS from the statistics and
    sums over the group's heads, then the q tiles at or after its key
    block. Products in f32; T(x) rounds to the inputs' dtype.

    bf16 inputs take the wgmma route's roundings: D is summed as dP_i0 +
    sum P (dP - dP_i0), P is exp2 of base-2 logits times 1 / l; dS enters
    dq += dS k and dk += dS^T q as hi = bf16(dS) and lo = bf16(dS - hi);
    dout is the operand as it is when bf16, and an f32 dout is split the
    same way; each pair of products sums to that of hi + lo (exact in
    f32); the dk/dv kernel walks 32-row q tiles. f32 inputs take the
    CUDA-core route: no rounding but T, 64-row q-blocks."""
    dt = q.dtype
    tc = dt == torch.bfloat16
    b, hq, n, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    nb = -(-n // blk)
    pad = nb * blk - n

    def tiles(x):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, pad))

    def t_round(x):
        return x.to(dt).float()

    def operand(x):                     # dS as bf16 hi + lo operands
        if not tc:
            return x
        hi = x.to(torch.bfloat16).float()
        return hi + (x - hi).to(torch.bfloat16).float()

    # the bf16 route: logits in base-2 units (scale log2(e)), exp2, and P
    # times 1 / l
    sl = torch.tensor(scale, dtype=torch.float32) * (
        torch.tensor(math.log2(math.e), dtype=torch.float32) if tc else 1)
    ex = torch.exp2 if tc else torch.exp

    def probs(s, m, lc):
        e = ex(s - m[..., None])
        return e * (1 / lc)[..., None] if tc else e / lc[..., None]

    if tc and dout.dtype == torch.float32:
        hi = dout.to(torch.bfloat16).float()
        dout = hi + (dout - hi).to(torch.bfloat16).float()
    qf, kf, vf, dof = (tiles(x) for x in (q, k, v, dout))
    kx = kf.repeat_interleave(g, dim=1)
    vx = vf.repeat_interleave(g, dim=1)

    def tile(rows, cols):
        live = ((cols[None, :] <= rows[:, None]) & (cols[None, :] < n)
                & (rows[:, None] < n))
        qs, ks = qf[:, :, rows], kx[:, :, cols]
        s = torch.where(live, (qs @ ks.transpose(-1, -2)) * sl,
                        torch.tensor(-1e30))
        dp = t_round(dof[:, :, rows] @ vx[:, :, cols].transpose(-1, -2))
        return s, dp

    stats = torch.zeros((3, b, hq, nb * blk))
    dq = torch.zeros_like(qf)
    for qb in range(nb):
        rows = qb * blk + torch.arange(blk)
        m = torch.full((b, hq, blk), -1e30)
        l_ = torch.zeros((b, hq, blk))
        dn = torch.zeros((b, hq, blk))
        c = torch.zeros((b, hq, blk))   # bf16 route: D shifted by dP_i0
        for kt in range(qb + 1):
            s, dp = tile(rows, kt * blk + torch.arange(blk))
            if tc and kt == 0:
                c = dp[..., 0]
            m_new = torch.maximum(m, s.amax(-1))
            alpha = ex(m - m_new)
            e = ex(s - m_new[..., None])
            l_ = l_ * alpha + e.sum(-1)
            dn = dn * alpha + (e * (dp - c[..., None])).sum(-1)
            m = m_new
        lc = torch.clamp(l_, min=1e-30)
        dd = c + dn / lc
        stats[:, :, :, rows] = torch.stack((m, lc, dd))
        for kt in range(qb + 1):
            cols = kt * blk + torch.arange(blk)
            s, dp = tile(rows, cols)
            p = probs(s, m, lc)
            ds = p * (dp - dd[..., None]) * scale
            dq[:, :, rows] += operand(ds) @ kx[:, :, cols]
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    qt = 32 if tc else blk
    for kb in range(nb):
        cols = kb * blk + torch.arange(blk)
        for h in range(g):
            heads = torch.arange(hk) * g + h
            for r0 in range(kb * blk, nb * blk, qt):
                rows = r0 + torch.arange(qt)
                m, lc, dd = (x[:, heads][..., rows] for x in stats)
                s, dp = (x[:, heads] for x in tile(rows, cols))
                p = probs(s, m, lc)
                ds = p * (dp - dd[..., None]) * scale
                dv[:, :, cols] += t_round(p).transpose(-1, -2) @ \
                    dof[:, heads][:, :, rows]
                dk[:, :, cols] += operand(ds).transpose(-1, -2) @ \
                    qf[:, heads][:, :, rows]
    return tuple(x[:, :, :n].to(dt) for x in (dq, dk, dv))


def _assert_kernel_close(a, w):
    """f32: within 1e-5 (the sum order alone). bf16: both round the same
    f32 sums, taken in other orders, to bf16, so each element is held to
    one bf16 ulp of itself plus one of the largest gradient of its row (dq:
    its query row; dk, dv: its key row): the gradients shrink along the
    sequence, so a limit set by the largest one alone would miss a wrong
    tail."""
    diff = (a.float() - w.float()).abs()
    if w.dtype == torch.float32:
        assert float(diff.max()) <= 1e-5
        return
    mag = w.float().abs()
    limit = 2.0 ** -7 * (mag + mag.amax(-1, keepdim=True))
    assert bool((diff <= limit).all()), float((diff - limit).max())


@pytest.mark.parametrize("dtype,g,n", [
    (torch.float32, 1, 64), (torch.float32, 3, 150), (torch.float32, 2, 200),
    (torch.bfloat16, 1, 100), (torch.bfloat16, 4, 129)])
def test_kernel_algorithm_matches_plain_version(dtype, g, n):
    """The kernels' blocked algorithm (online statistics, tiles up to the
    diagonal, the ragged last block masked, dk/dv in head then block
    order) against the plain version, to `_assert_kernel_close`."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(2, 2 * g, 2, n,
                                                          16, seed=n + g))
    q, k, v = (x.to(dtype) for x in (q, k, v))
    got = _emulate_kernel(q, k, v, dout, 0.25)
    want = ref.flash_prefill_bwd_ref(q, k, v, dout)
    for a, w in zip(got, want):
        _assert_kernel_close(a, w)


@pytest.mark.parametrize("g,n,d,dout_dtype", [
    (4, 129, 64, torch.float32), (4, 129, 64, torch.bfloat16),
    (1, 100, 16, torch.bfloat16)])
def test_kernel_algorithm_takes_a_bf16_cotangent_and_wide_heads(
        g, n, d, dout_dtype):
    """The bf16 route's algorithm with the model's bf16 cotangent (dout the
    operand as it is) and at granite-3-2b's group and head dim (G = 4, d =
    64; an f32 dout split into hi and lo), against the plain version on
    the same bf16-valued dout, to `_assert_kernel_close`."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(2, 2 * g, 2, n,
                                                          d, seed=n + d))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    dout = dout.to(dout_dtype)
    got = _emulate_kernel(q, k, v, dout, d ** -0.5)
    want = ref.flash_prefill_bwd_ref(q, k, v, dout)
    for a, w in zip(got, want):
        _assert_kernel_close(a, w)


def _common_key_inputs(seed, b=2, hq=4, hk=2, n=129, d=64):
    """bf16 q, k, v and a bf16 dout whose keys share a large common vector
    (k_j = c + delta_j, |c| about 8 |delta|), as a model's projections do:
    sum_j dS_ij = 0 cancels c out of dq exactly, and only as far as the
    products keep dS."""
    rng = np.random.default_rng(seed)
    q = 0.3 * rng.standard_normal((b, hq, n, d))
    c = 4 + rng.standard_normal((1, hk, 1, d))
    k = c + 0.5 * rng.standard_normal((b, hk, n, d))
    v = rng.standard_normal((b, hk, n, d))
    dout = rng.standard_normal((b, hq, n, d))
    return [torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
            for x in (q, k, v, dout)]


def test_kernel_algorithm_holds_keys_with_a_common_component():
    """The bf16 route's dS enters dq += dS k as bf16 hi + lo: a key
    component common to every key cancels out of dq as in the plain
    version's f32 product (with dS rounded to bf16 alone, dq misses
    `_assert_kernel_close` here)."""
    q, k, v, dout = _common_key_inputs(4)
    got = _emulate_kernel(q, k, v, dout, 64 ** -0.5)
    want = ref.flash_prefill_bwd_ref(q, k, v, dout)
    for a, w in zip(got, want):
        _assert_kernel_close(a, w)


@pytest.mark.parametrize("dout_dtype", [torch.float32, torch.bfloat16])
def test_kernel_algorithm_gives_a_zero_gradient_row_exactly_zero(dout_dtype):
    """With v_0 = v_1 every row's dP at keys 0 and 1 are equal, so row 1
    (which sees only those keys) has gradient 0 exactly. The bf16 route
    sums D as dP_i0 + sum P (dP - dP_i0), which is then dP_i0 exactly, so
    dS and dq of row 1 are exactly 0; an unshifted sum leaves f32 rounding
    noise there, which a per-row limit cannot hold."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(2, 4, 1, 70, 16,
                                                          seed=5))
    v[:, :, 1] = v[:, :, 0]
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    dq, _, _ = _emulate_kernel(q, k, v, dout.to(dout_dtype), 0.25)
    assert bool((dq[:, :, 1] == 0).all())
    assert bool((dq[:, :, 2:].float().abs().amax(-1) > 0).all())


@pytest.mark.parametrize("g", [1, 4])
def test_causal_attention_bf16_out_matches_reference_cast(g):
    """`ops.causal_attention(..., out_dtype=bf16)`, the model's call, holds
    the forward and the gradients of `chunked_causal_attention(...)[0]
    .astype(bf16)` under `jax.vjp`: the cast inside the autograd Function
    gives the backward the bf16 cotangent the reference's cast gives."""
    jax, jnp, cca = _jax()
    n, chunk = 45, 16
    q, k, v, dout = _inputs(2, 2 * g, 2, n, 16, seed=31 + g)
    args = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    out, vjp = jax.vjp(
        lambda a, b_, c: cca(a, b_, c, chunk=chunk)[0].astype(jnp.bfloat16),
        *args)
    ct = jnp.asarray(dout).astype(jnp.bfloat16)
    want = [np.asarray(x.astype(jnp.float32)) for x in (out, *vjp(ct))]
    leaves = [torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
              for x in (q, k, v)]
    got = ops.causal_attention(*leaves, chunk=chunk,
                               out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    # a probability's one-ulp flip (2^-8 |v|), then one bf16 ulp of out
    # where the f32 outs straddle a rounding boundary
    err = np.abs(got.detach().float().numpy() - want[0])
    assert (err <= 2.0 ** -8 * (np.abs(v).max() + np.abs(want[0]))).all()
    got.backward(torch.from_numpy(np.array(ct.astype(jnp.float32))).to(
        torch.bfloat16))
    for leaf, w in zip(leaves, want[1:]):
        err = np.abs(leaf.grad.float().numpy() - w).max()
        assert err <= _bound(torch.bfloat16, n, chunk, np.abs(w).max()), err


def test_kernel_wrapper_takes_an_f32_or_bf16_cotangent_only():
    """dout may be f32, or bf16 with bf16 q, k and v; any other is refused
    before a launch (a CPU tensor then fails the device check: its dtype
    was taken)."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 8, 16, 0))
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
    for dt in (torch.float16, torch.float64, torch.int8):
        with pytest.raises(TypeError, match="dout"):
            bwd_mod.flash_prefill_bwd(q, k, v, dout.to(dt))
    with pytest.raises(TypeError, match="dout"):
        bwd_mod.flash_prefill_bwd(q.float(), k.float(), v.float(),
                                  dout.to(torch.bfloat16))
    for dt in (torch.float32, torch.bfloat16):
        with pytest.raises(ValueError, match="CUDA"):
            bwd_mod.flash_prefill_bwd(q, k, v, dout.to(dt))
    assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before


def test_kernel_wrapper_refuses_cpu_tensors_and_counts_nothing():
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 8, 16, 0))
    before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
    with pytest.raises(ValueError, match="CUDA"):
        bwd_mod.flash_prefill_bwd(q, k, v, dout)
    with pytest.raises(ValueError, match="multiple of 16"):
        bwd_mod.flash_prefill_bwd(q[..., :8], k[..., :8], v[..., :8],
                                  dout[..., :8])
    with pytest.raises(TypeError):
        bwd_mod.flash_prefill_bwd(q.half(), k.half(), v.half(), dout)
    assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before


def test_kernel_wrapper_routes_the_latent_shape_apart():
    """A head-dim pair past the GQA route's is refused naming MLA's latent
    shape, which takes a route of its own: (576, 512) with V the view of
    K's first 512 columns goes there, where an f32 latent is refused (the
    route is bf16), before any launch."""
    q, k, v, dout = (torch.from_numpy(x) for x in _inputs(1, 2, 1, 8, 192,
                                                          0))
    before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
    with pytest.raises(ValueError, match=r"\(576, 512\)"):
        bwd_mod.flash_prefill_bwd(q, k, v, dout)
    u = torch.zeros((1, 1, 8, 576))
    with pytest.raises(TypeError, match="latent route"):
        bwd_mod.flash_prefill_bwd(torch.zeros((1, 2, 8, 576)), u,
                                  u[..., :512], torch.zeros((1, 2, 8, 512)))
    assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before


# ---------------------------------------------------------------------------
# on a card
# ---------------------------------------------------------------------------


def _needs_card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hk,n,d,dtype", [
    (2, 8, 2, 300, 64, torch.bfloat16),
    (1, 4, 4, 129, 128, torch.bfloat16),
    (1, 12, 1, 200, 112, torch.bfloat16),
    (2, 4, 2, 100, 16, torch.float32),
    (1, 2, 1, 64, 128, torch.float32),
])
def test_backward_kernel_matches_plain_version_on_card(b, hq, hk, n, d,
                                                       dtype):
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(n + d)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(
        dtype) for h in (hq, hk, hk))
    dout = torch.randn((b, hq, n, d), generator=gen, device="cuda")
    before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
    got = ops.prefill_attention_bwd(q, k, v, dout)
    again = ops.prefill_attention_bwd(q, k, v, dout)
    torch.cuda.synchronize()
    assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before + 2
    want = ref.flash_prefill_bwd_ref(q, k, v, dout)
    for a, a2, w in zip(got, again, want):
        assert a.dtype == dtype and torch.equal(a, a2)      # deterministic
        _assert_kernel_close(a, w)


@pytest.mark.gpu
def test_backward_kernel_holds_keys_with_a_common_component_on_card():
    """The bf16 route on keys that share a large common vector (dS as hi +
    lo operands), with the model's bf16 dout and with it in f32."""
    _needs_card()
    q, k, v, dout = (x.cuda() for x in _common_key_inputs(9, n=300))
    want = ref.flash_prefill_bwd_ref(q, k, v, dout)
    for cot in (dout, dout.float()):
        got = bwd_mod.flash_prefill_bwd(q, k, v, cot)
        torch.cuda.synchronize()
        for a, w in zip(got, want):
            _assert_kernel_close(a, w)


@pytest.mark.gpu
def test_backward_kernel_gives_a_zero_gradient_row_exactly_zero_on_card():
    """The bf16 route on the card: with v_0 = v_1, row 1's gradient is 0
    exactly (its two dP are equal), and the kernel's dq there is 0 bit for
    bit, with a bf16 and with an f32 dout."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(11)
    q, k, v = (torch.randn((2, h, 200, 64), generator=gen, device="cuda")
               for h in (8, 2, 2))
    v[:, :, 1] = v[:, :, 0]
    q, k, v = (x.to(torch.bfloat16) for x in (q, k, v))
    dout = torch.randn((2, 8, 200, 64), generator=gen, device="cuda")
    for cot in (dout.to(torch.bfloat16), dout):
        dq, _, _ = bwd_mod.flash_prefill_bwd(q, k, v, cot)
        torch.cuda.synchronize()
        assert bool((dq[:, :, 1] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("b,hq,hk,n,d", [
    (2, 8, 2, 300, 64), (1, 4, 4, 129, 112), (2, 4, 1, 129, 64)])
def test_backward_kernel_takes_a_bf16_cotangent_on_card(b, hq, hk, n, d):
    """The bf16 route with a bf16 dout (the model's cotangent, the operand
    as it is) at ragged N, and the same dout in f32 (split into hi and lo):
    each within `_assert_kernel_close` of the plain version, two launches
    bit-equal, one count a backward."""
    _needs_card()
    gen = torch.Generator(device="cuda").manual_seed(n + d + 1)
    q, k, v = (torch.randn((b, h, n, d), generator=gen, device="cuda").to(
        torch.bfloat16) for h in (hq, hk, hk))
    dout = torch.randn((b, hq, n, d), generator=gen,
                       device="cuda").to(torch.bfloat16)
    want = ref.flash_prefill_bwd_ref(q, k, v, dout)
    for cot in (dout, dout.float()):
        before = bwd_mod.LAUNCHES["flash_prefill_bwd"]
        got = bwd_mod.flash_prefill_bwd(q, k, v, cot)
        again = bwd_mod.flash_prefill_bwd(q, k, v, cot)
        torch.cuda.synchronize()
        assert bwd_mod.LAUNCHES["flash_prefill_bwd"] == before + 2
        for a, a2, w in zip(got, again, want):
            assert a.dtype == torch.bfloat16 and torch.equal(a, a2)
            _assert_kernel_close(a, w)
