"""Parity of the plain PyTorch version of the `ragged_decode` kernel
(`repro_torch.kernels.ref.fused_decode_ref`) with the reference's Pallas
kernel (interpret mode, as the reference's own tests run it) and with the
reference's oracle `ref.fused_decode_ref(num_blocks=1)`.

G ∈ {1, 4}, bf16 and int8 K/V, mixed fills including 0 (a free lane) and
fills below select_k. `out` to 1e-5 and `probs` to 1e-6 (f32 on both
sides, sums taken in another order); probs at dead slots exactly 0."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.ragged_decode import ragged_decode as jax_ragged  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

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
