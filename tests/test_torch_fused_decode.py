"""Parity of the port's plain `fused_decode` (`repro_torch.kernels.ops`, on
CPU tensors `ref.fused_decode_ref`) with the reference's oracle
`ref.fused_decode_ref` and its Pallas kernel `fused_decode` (interpret
mode, as the reference's own tests run it).

num_blocks ∈ {1, 2, 3, 4}, f32, bf16 and int8 K/V, G ∈ {1, 4}, a row with
no valid slot, and ragged tails (S % num_blocks != 0) through both sides'
`ops.fused_decode`, which pad them with invalid slots. `out` to 1e-5 and
`probs` to 1e-6, as `tests/test_fused_decode.py` holds the TPU kernel
(f32 on both sides, sums taken in another order). Also at decode_32k's
S = 32,768 and select_k = 2,048 (the kernel's long route, above the
single-CTA route's old slot caps), G ∈ {1, 4, 12}, num_blocks ∈ {1, 4},
with inputs whose out names the winner set (`long_args`)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_decode import fused_decode as jax_fused  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from test_torch_ragged_decode import (_sides, assert_long_close,  # noqa: E402
                                      long_args)

jax.config.update("jax_platform_name", "cpu")


def decode_args(bh, g, d, dv, s, kv, seed, empty_row=True):
    """numpy inputs: ~80% of slots valid, ~10% of valid slots protected,
    and (with `empty_row`) row 0 without a valid slot."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g, d)).astype(np.float32)
    qq = rng.integers(-7, 8, (bh, g, d)).astype(np.int8)
    qs = (rng.random((bh, g)) + 0.05).astype(np.float32)
    mirror = rng.integers(-7, 8, (bh, s, d)).astype(np.int8)
    ms = (rng.random((bh, s)) + 0.05).astype(np.float32)
    if kv == "int8":
        k = rng.integers(-127, 128, (bh, s, d)).astype(np.int8)
        v = rng.integers(-127, 128, (bh, s, dv)).astype(np.int8)
        ks = (rng.random((bh, s)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((bh, s)) * 0.02 + 0.001).astype(np.float32)
    else:
        k = rng.standard_normal((bh, s, d)).astype(np.float32)
        v = rng.standard_normal((bh, s, dv)).astype(np.float32)
        ks = np.ones((bh, s), np.float32)
        vs = ks
    valid = (rng.random((bh, s)) < 0.8).astype(np.int8)
    if empty_row:
        valid[0] = 0
    prot = (rng.random((bh, s)) < 0.1).astype(np.int8) * valid
    return [q, qq, qs, mirror, ms, ks, vs, valid, prot, k, v]


def both_sides(args, kv):
    """The same inputs for both frameworks; bf16 mode stores q, K and V as
    bf16."""
    j, t = [], []
    for i, a in enumerate(args):
        bf16 = kv == "bf16" and i in (0, 9, 10)
        j.append(jnp.asarray(a, jnp.bfloat16 if bf16 else None))
        tt = torch.as_tensor(a)
        t.append(tt.to(torch.bfloat16) if bf16 else tt)
    return j, t


def assert_close(got, want):
    out_t, probs_t = got
    out_j, probs_j = want
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(probs_t.numpy(), np.asarray(probs_j),
                               atol=1e-6, rtol=0)


CASES = [
    # bh, g, d, dv, s, num_blocks, select_k, kv
    (2, 1, 32, 32, 64, 1, 16, "f32"),
    (2, 4, 32, 32, 64, 2, 16, "bf16"),
    (3, 4, 16, 24, 48, 4, 8, "int8"),       # dv != d
    (2, 1, 16, 16, 96, 3, 12, "bf16"),
    (2, 4, 32, 32, 64, 4, 16, "f32"),
    (3, 1, 32, 32, 64, 2, 8, "int8"),
]


@pytest.mark.parametrize("bh,g,d,dv,s,nb,sk,kv", CASES)
def test_plain_fused_decode_matches_reference_oracle(bh, g, d, dv, s, nb, sk,
                                                     kv):
    jargs, targs = both_sides(decode_args(bh, g, d, dv, s, kv, seed=s + nb),
                              kv)
    want = jref.fused_decode_ref(*jargs, select_k=sk, num_blocks=nb)
    got = ops.fused_decode(*targs, select_k=sk, num_blocks=nb)
    assert_close(got, want)
    assert not got[0][0].any() and not got[1][0].any()   # no valid slot


@pytest.mark.parametrize("bh,g,d,dv,s,nb,sk,kv", CASES)
def test_plain_fused_decode_matches_reference_kernel(bh, g, d, dv, s, nb, sk,
                                                     kv):
    jargs, targs = both_sides(
        decode_args(bh, g, d, dv, s, kv, seed=2 * s + g), kv)
    want = jax_fused(*jargs, select_k=sk, num_blocks=nb, interpret=True)
    assert_close(ops.fused_decode(*targs, select_k=sk, num_blocks=nb), want)


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("bh,g,d,s,nb,sk,kv", [
    (2, 4, 16, 50, 3, 12, "bf16"),          # 50 = 3·16 + 2: one pad slot
    (2, 1, 32, 70, 4, 16, "int8"),          # 70 = 4·17 + 2: two pad slots
    (3, 1, 16, 45, 2, 8, "f32"),
])
def test_plain_fused_decode_ragged_tail_matches_reference_ops(
        backend, bh, g, d, s, nb, sk, kv):
    """Both sides' ops pad S up to a multiple of num_blocks with invalid
    slots and cut probs back to S."""
    jargs, targs = both_sides(decode_args(bh, g, d, d, s, kv, seed=s), kv)
    want = jops.fused_decode(*jargs, select_k=sk, num_blocks=nb,
                             backend=backend)
    got = ops.fused_decode(*targs, select_k=sk, num_blocks=nb)
    assert got[1].shape == (bh, s)
    assert_close(got, want)


def test_plain_fused_decode_with_one_block_equals_the_global_race():
    """num_blocks == 1 with or without fills is the ragged kernel's plain
    version: one global race."""
    args = both_sides(decode_args(3, 2, 16, 16, 40, "bf16", seed=5), "bf16")[1]
    fills = torch.tensor([40, 40, 40], dtype=torch.int32)
    a = ops.fused_decode(*args, select_k=8)
    b = ops.fused_decode(*args, select_k=8, fills=fills)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("bits", [False, True], ids=["random", "bits"])
@pytest.mark.parametrize("quantized", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("nb", [1, 4])
@pytest.mark.parametrize("g", [1, 4, 12])
def test_plain_fused_decode_at_decode_32k_matches_reference_oracle(
        g, nb, quantized, bits):
    """S = 32,768, select_k = 2,048 (8,192-slot blocks racing for 512 each
    at nb = 4), d = 16: one full row, one ragged (slots past its fill
    invalid)."""
    bh, d, s, k = 2, 16, 32768, 2048
    fl, args = long_args(bh, g, d, s, [s, s - 777], quantized,
                         seed=10 * g + nb, bits=bits)
    jargs, targs = _sides(args, quantized)
    want = jref.fused_decode_ref(*jargs, select_k=k, num_blocks=nb)
    got = ops.fused_decode(*targs, select_k=k, num_blocks=nb)
    assert_long_close(got, want, fl)
