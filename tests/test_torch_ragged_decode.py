"""Parity of the plain PyTorch version of the `ragged_decode` kernel
(`repro_torch.kernels.ref.fused_decode_ref`) with the reference's Pallas
kernel (interpret mode, as the reference's own tests run it) and with the
reference's oracle `ref.fused_decode_ref(num_blocks=1)`.

G ∈ {1, 4}, bf16 and int8 K/V, mixed fills including 0 (a free lane) and
fills below select_k. `out` to 1e-5 and `probs` to 1e-6 (f32 on both
sides, sums taken in another order); probs at dead slots exactly 0.

Above the single-CTA route's old slot caps (22,640 slots at G = 1, d =
128; 3,957 at G = 12) the kernel takes its long route; its plain version
is the same function, held here to the oracle at decode_32k's S = 32,768
and select_k = 2,048 (G ∈ {1, 4, 12}) and at long_500k's S = 524,288, at
narrow width, with inputs whose out names the winner set."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ragged_decode import ragged_decode as jax_ragged  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _args(bh, g, d, dv, s, fills, quantized, seed):
    """numpy inputs with the cache's discipline: slots >= fill invalid."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g, d)).astype(np.float32)
    qq = rng.integers(-7, 8, (bh, g, d)).astype(np.int8)
    qs = (rng.random((bh, g)) + 0.05).astype(np.float32)
    mirror = rng.integers(-7, 8, (bh, s, d)).astype(np.int8)
    ms = (rng.random((bh, s)) + 0.05).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (bh, s, d)).astype(np.int8)
        v = rng.integers(-127, 128, (bh, s, dv)).astype(np.int8)
        ks = (rng.random((bh, s)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((bh, s)) * 0.02 + 0.001).astype(np.float32)
    else:
        k = rng.standard_normal((bh, s, d)).astype(np.float32)
        v = rng.standard_normal((bh, s, dv)).astype(np.float32)
        ks = np.ones((bh, s), np.float32)
        vs = ks
    fills = np.asarray(fills, np.int32)
    valid = (np.arange(s)[None, :] < fills[:, None]).astype(np.int8)
    prot = (rng.random((bh, s)) < 0.1).astype(np.int8) * valid
    return fills, [q, qq, qs, mirror, ms, ks, vs, valid, prot, k, v]


def _sides(args, quantized):
    """The same inputs for both sides; non-quantized K/V and q as bf16."""
    j, t = [], []
    for i, a in enumerate(args):
        bf16 = not quantized and i in (0, 9, 10)
        j.append(jnp.asarray(a, jnp.bfloat16 if bf16 else None))
        tt = torch.as_tensor(a)
        t.append(tt.to(torch.bfloat16) if bf16 else tt)
    return j, t


CASES = [
    # bh, g, d, dv, s, select_k, fills, quantized
    (4, 1, 32, 32, 64, 16, [5, 30, 64, 0], False),   # MHA: < k, ragged, full, free
    (4, 1, 32, 32, 64, 16, [64, 0, 11, 47], True),
    (3, 4, 16, 24, 100, 8, [100, 3, 42], False),     # GQA G=4, ragged S
    (3, 4, 16, 24, 100, 8, [0, 17, 100], True),
]


@pytest.mark.parametrize("bh,g,d,dv,s,sk,fills,quantized", CASES)
def test_plain_ragged_decode_matches_reference_kernel(bh, g, d, dv, s, sk,
                                                      fills, quantized):
    fl, args = _args(bh, g, d, dv, s, fills, quantized, seed=s + sk + g)
    jargs, targs = _sides(args, quantized)
    out_k, probs_k = jax_ragged(jnp.asarray(fl), *jargs, select_k=sk,
                                block_s=16, interpret=True)
    out_t, probs_t = ref.fused_decode_ref(*targs, select_k=sk)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_k), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_k),
                               atol=1e-6, rtol=0)
    dead = np.arange(s)[None, :] >= fl[:, None]
    assert not probs_t.numpy()[dead].any()
    free = fl == 0                       # a free lane: zeros, never NaN
    assert not out_t.numpy()[free].any()


@pytest.mark.parametrize("bh,g,d,dv,s,sk,fills,quantized", CASES)
def test_plain_ragged_decode_matches_reference_oracle(bh, g, d, dv, s, sk,
                                                      fills, quantized):
    fl, args = _args(bh, g, d, dv, s, fills, quantized, seed=2 * s + g)
    jargs, targs = _sides(args, quantized)
    out_j, probs_j = jref.fused_decode_ref(*jargs, select_k=sk, num_blocks=1)
    out_t, probs_t = ref.fused_decode_ref(*targs, select_k=sk)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               atol=1e-6, rtol=0)


def long_args(bh, g, d, s, fills, quantized, seed, bits=False):
    """`_args` at a long cache with dyadic scales: every score and every
    G-row sum is exact in f32, whatever the order of its additions, so
    both packages race on the same values (and tie in runs: 16 scale
    levels). With `bits` the inputs name the winner set: a lane's K rows
    equal (each valid winner weighs 1/n), V[s][c] = bit c of s and vscale
    = 1, so out[c] is the share of valid winners with bit c set and one
    wrong winner moves it by at least 1/n (1/2048 here, far above 1e-5);
    mirror codes in {0, 1} and query codes in {-1, 0, 1}; every valid slot
    of the last row protected (more than select_k)."""
    fills, a = _args(bh, g, d, d, s, fills, quantized, seed)
    rng = np.random.default_rng(seed + 1)
    a[2] = ((1 + rng.integers(0, 16, (bh, g)) / 16) / 4).astype(np.float32)
    a[4] = ((1 + rng.integers(0, 16, (bh, s)) / 16) / 8).astype(np.float32)
    if bits:
        a[1] = rng.integers(-1, 2, (bh, g, d)).astype(np.int8)
        a[3] = (rng.random((bh, s, d)) < 0.08).astype(np.int8)
        a[9] = np.ascontiguousarray(np.broadcast_to(a[9][:, :1], a[9].shape))
        slot_bits = (np.arange(s)[:, None] >> np.arange(d)[None, :]) & 1
        a[10] = np.ascontiguousarray(np.broadcast_to(
            slot_bits.astype(a[10].dtype), a[10].shape))
        a[6] = np.ones((bh, s), np.float32)
        a[8][-1] = a[7][-1]
    return fills, a


def assert_long_close(got, want, fills):
    """out to 1e-5 and probs to 1e-6 absolute, zero past each fill; and
    probs at its own scale (a long row's probs average G / live, 1.2e-4
    at G = 4 and S = 32,768, 7.6e-6 at 524,288): each slot within 1e-4 of
    |p| plus that share, each row's sum G (0 for a free row) within 1e-5
    of G."""
    out_t, probs_t = got
    out_j, probs_j = want
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               atol=1e-6, rtol=0)
    s, g = probs_t.shape[1], out_t.shape[1]
    dead = np.arange(s)[None, :] >= np.asarray(fills)[:, None]
    assert not probs_t.numpy()[dead].any()
    p = probs_t.double().numpy()
    pr = np.asarray(probs_j, np.float64)
    live = np.minimum(np.asarray(fills), s)[:, None]
    err = np.abs(p - pr) / (np.abs(pr) + g / np.maximum(live, 1))
    assert err.max() <= 1e-4, err.max()
    want_sum = (live[:, 0] > 0) * float(g)
    assert np.abs(p.sum(-1) - want_sum).max() <= 1e-5 * g


@pytest.mark.parametrize("bits", [False, True], ids=["random", "bits"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("g", [1, 4, 12])
def test_plain_ragged_decode_at_decode_32k_matches_reference_oracle(
        g, quantized, bits):
    """S = 32,768, select_k = 2,048, d = 16: one full row, one ragged."""
    bh, d, s, k = 2, 16, 32768, 2048
    fl, args = long_args(bh, g, d, s, [s, s - 777], quantized, seed=g,
                         bits=bits)
    jargs, targs = _sides(args, quantized)
    want = jref.fused_decode_ref(*jargs, select_k=k, num_blocks=1)
    got = ops.fused_decode(*targs, select_k=k, fills=torch.as_tensor(fl))
    assert_long_close(got, want, fl)


@pytest.mark.parametrize("bits", [False, True], ids=["random", "bits"])
def test_plain_ragged_decode_at_long_500k_matches_reference_oracle(bits):
    """S = 524,288, select_k = 2,048, G = 4 (granite-3-2b's long_500k),
    int8 K/V at d = 32 (the slot bits need 19 columns): one full row, one
    ragged."""
    bh, g, d, s, k = 2, 4, 32, 524288, 2048
    fl, args = long_args(bh, g, d, s, [s, 300001], True, seed=5, bits=bits)
    jargs, targs = _sides(args, True)
    want = jref.fused_decode_ref(*jargs, select_k=k, num_blocks=1)
    got = ops.fused_decode(*targs, select_k=k, fills=torch.as_tensor(fl))
    assert_long_close(got, want, fl)
