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
- the kernels' blocked algorithm, emulated in PyTorch (online row
  statistics, ragged N, dk/dv in head then q-block order), against the
  plain version: f32 1e-5, bf16 each element within one bf16 ulp of
  itself plus one of the largest gradient of its row;
- `attention_train` (the block's attention sublayer, causal and not)
  against the reference's, with the gradients of every projection, f32.
- the kernel wrapper's refusals on the CPU and the launch counter.
- on a card only (`-m gpu`): the kernel against its plain version at
  bf16 and f32, GQA and d = 16 … 128, two launches bit-equal, one count a
  backward.
"""
from __future__ import annotations

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
    sums over the group's heads, then the q-blocks at or after its key
    block. Products in f32; T(x) rounds to the inputs' dtype."""
    dt = q.dtype
    b, hq, n, d = q.shape
    hk = k.shape[1]
    g = hq // hk
    nb = -(-n // blk)
    pad = nb * blk - n

    def tiles(x):
        return torch.nn.functional.pad(x.float(), (0, 0, 0, pad))

    def t_round(x):
        return x.to(dt).float()

    qf, kf, vf, dof = (tiles(x) for x in (q, k, v, dout))
    kx = kf.repeat_interleave(g, dim=1)
    vx = vf.repeat_interleave(g, dim=1)
    idx = torch.arange(blk)

    def tile(qb, kt):
        rows, cols = qb * blk + idx, kt * blk + idx
        live = ((cols[None, :] <= rows[:, None]) & (cols[None, :] < n)
                & (rows[:, None] < n))
        qs, ks = qf[:, :, rows], kx[:, :, cols]
        s = torch.where(live, (qs @ ks.transpose(-1, -2)) * scale,
                        torch.tensor(-1e30))
        dp = t_round(dof[:, :, rows] @ vx[:, :, cols].transpose(-1, -2))
        return s, dp

    stats = []
    dq = torch.zeros_like(qf)
    for qb in range(nb):
        m = torch.full((b, hq, blk), -1e30)
        l_ = torch.zeros((b, hq, blk))
        dn = torch.zeros((b, hq, blk))
        for kt in range(qb + 1):
            s, dp = tile(qb, kt)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            e = torch.exp(s - m_new[..., None])
            l_ = l_ * alpha + e.sum(-1)
            dn = dn * alpha + (e * dp).sum(-1)
            m = m_new
        lc = torch.clamp(l_, min=1e-30)
        dd = dn / lc
        stats.append((m, lc, dd))
        for kt in range(qb + 1):
            s, dp = tile(qb, kt)
            p = torch.exp(s - m[..., None]) / lc[..., None]
            ds = p * (dp - dd[..., None]) * scale
            dq[:, :, qb * blk + idx] += ds @ kx[:, :, kt * blk + idx]
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for kb in range(nb):
        cols = kb * blk + idx
        for h in range(g):
            heads = torch.arange(hk) * g + h
            for qb in range(kb, nb):
                m, lc, dd = (x[:, heads] for x in stats[qb])
                s, dp = (x[:, heads] for x in tile(qb, kb))
                p = torch.exp(s - m[..., None]) / lc[..., None]
                ds = p * (dp - dd[..., None]) * scale
                rows = qb * blk + idx
                dv[:, :, cols] += t_round(p).transpose(-1, -2) @ \
                    dof[:, heads][:, :, rows]
                dk[:, :, cols] += ds.transpose(-1, -2) @ \
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
