"""Parity of the plain versions of the port's small decode kernels with the
reference, and of the int4 packing they read.

- `approx_score` (`ops.approx_score`) and `approx_score_packed`
  (`ref.approx_score_packed_ref`) equal the reference's Pallas kernels
  (interpret mode) bit for bit: both contract integers exactly and scale in
  the same order.
- `pack_int4` / `unpack_int4` round-trip and equal the reference byte for
  byte; `mirror_bytes_per_token` and `quantize_packed` agree.
- `gather_attention` (`ops.gather_attention`) is within 1e-5 of the
  reference's op on rows with a valid slot. On a row with no valid slot it
  equals the reference's oracle (the mean of its K value rows); the
  reference's op pads K to its TPU block of 512 first and so averages over
  the padding there, a quirk of the reference (ROADMAP Queue C)."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import quant as jquant  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.approx_score import (  # noqa: E402
    approx_score_packed as jax_packed)
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def score_args(bh, g, d, s, seed, code_hi=128):
    rng = np.random.default_rng(seed)
    qq = rng.integers(-127, 128, (bh, g, d)).astype(np.int8)
    qs = (rng.random((bh, g)) + 0.01).astype(np.float32)
    kq = rng.integers(-code_hi, code_hi, (bh, s, d)).astype(np.int8)
    ks = (rng.random((bh, s)) + 0.01).astype(np.float32)
    valid = (rng.random((bh, s)) < 0.8).astype(np.int8)
    return qq, qs, kq, ks, valid


@pytest.mark.parametrize("bh,g,d,s", [(3, 1, 64, 64), (2, 4, 32, 100),
                                      (2, 8, 16, 37)])
def test_approx_score_equals_reference_bitwise(bh, g, d, s):
    args = score_args(bh, g, d, s, seed=s + g)
    got = ops.approx_score(*map(torch.as_tensor, args)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jops.approx_score(*map(jnp.asarray, args))))
    np.testing.assert_array_equal(
        got, np.asarray(jref.approx_score_ref(*map(jnp.asarray, args))))
    assert (got[np.broadcast_to(args[4][:, None, :] == 0, got.shape)]
            == ref.NEG_INF).all()


@pytest.mark.parametrize("bh,g,d,s,block", [(2, 1, 32, 64, 64),
                                            (3, 4, 64, 96, 32)])
def test_approx_score_packed_equals_reference_bitwise(bh, g, d, s, block):
    qq, qs, codes, ks, valid = score_args(bh, g, d, s, seed=d, code_hi=8)
    packed = np.array(jquant.pack_int4(jnp.asarray(codes)))
    want = jax_packed(jnp.asarray(qq), jnp.asarray(qs), jnp.asarray(packed),
                      jnp.asarray(ks), jnp.asarray(valid), block_s=block,
                      interpret=True)
    got = ref.approx_score_packed_ref(*map(torch.as_tensor,
                                           (qq, qs, packed, ks, valid)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # scoring the packed mirror is scoring its codes
    np.testing.assert_array_equal(
        got.numpy(), ops.approx_score(*map(torch.as_tensor,
                                           (qq, qs, codes, ks, valid))).numpy())


def test_pack_int4_round_trips_and_equals_reference_bytes():
    codes = np.random.default_rng(0).integers(-8, 8, (3, 5, 32)).astype(
        np.int8)
    codes[0, 0, :16] = np.arange(-8, 8)          # every code once
    packed = quant.pack_int4(torch.as_tensor(codes))
    assert packed.dtype == torch.uint8 and packed.shape == (3, 5, 16)
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jquant.pack_int4(jnp.asarray(codes))))
    np.testing.assert_array_equal(quant.unpack_int4(packed).numpy(), codes)
    np.testing.assert_array_equal(
        quant.unpack_int4(packed).numpy(),
        np.asarray(jquant.unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("bits", [1, 2, 3, 4, 8])
def test_packed_storage_matches_reference(bits):
    for head_dim in (64, 96, 128):
        assert (quant.mirror_bytes_per_token(head_dim, bits)
                == jquant.mirror_bytes_per_token(head_dim, bits))
    x = np.random.default_rng(bits).standard_normal((2, 3, 16)).astype(
        np.float32)
    tq, ts = quant.quantize_packed(torch.as_tensor(x), bits)
    jq, js = jquant.quantize_packed(jnp.asarray(x), bits)
    assert tq.dtype == (torch.uint8 if bits <= 4 else torch.int8)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-7, atol=0)


@pytest.mark.parametrize("g,d,dv,kk,dtype", [(1, 32, 32, 128, np.float32),
                                             (4, 16, 24, 128, np.float32),
                                             (2, 64, 64, 40, "bf16")])
def test_gather_attention_matches_reference(g, d, dv, kk, dtype):
    bh = 4
    rng = np.random.default_rng(kk + g)
    q = rng.standard_normal((bh, g, d)).astype(np.float32)
    k = rng.standard_normal((bh, kk, d)).astype(np.float32)
    v = rng.standard_normal((bh, kk, dv)).astype(np.float32)
    valid = (rng.random((bh, kk)) < 0.7).astype(np.int8)
    valid[1] = 0                                 # no valid slot
    valid[2] = 1                                 # every slot valid
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    jargs = [jnp.asarray(a, jdt) for a in (q, k, v)] + [jnp.asarray(valid)]
    targs = [torch.as_tensor(a).to(tdt) for a in (q, k, v)] + [
        torch.as_tensor(valid)]
    got = ops.gather_attention(*targs).numpy()
    live = valid.any(axis=1)
    np.testing.assert_allclose(got[live],
                               np.asarray(jops.gather_attention(*jargs))[live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jref.gather_attention_ref(
        *jargs)), atol=1e-5, rtol=0)
    mean_v = targs[2].float().mean(dim=1)[1].numpy()
    np.testing.assert_allclose(got[1], np.broadcast_to(mean_v, (g, dv)),
                               atol=1e-6, rtol=0)
    # the reference's op averages the all-invalid row over its zero padding
    assert np.abs(np.asarray(jops.gather_attention(*jargs))[1]
                  - got[1]).max() > 1e-3
