"""Parity of the port's quantizer with the reference: the int8 codes are
EXACTLY equal for 1–8 bits (a code that moves by 1 changes the top-k sets
later on), zero rows and half-way values included; scales to 1e-6."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import quant as jq  # noqa: E402
from repro_torch.core import quant as tq  # noqa: E402

jax.config.update("jax_platform_name", "cpu")


def _inputs(bits, seed=0):
    rng = np.random.default_rng(seed + bits)
    x = rng.standard_normal((6, 3, 32)).astype(np.float32) * 3.0
    x[0, 0] = 0.0                                  # zero row: scale 0
    x[1, 1, 1:] = 0.0                              # one live element
    # exact half-way values x/s = n + 1/2: round-half-to-even decides them
    qm = tq.qmax_for_bits(bits)
    x[2, 0, 0] = qm                               # amax → scale 1.0
    x[2, 0, 1:8] = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5],
                            np.float32)[:7] * (qm >= 3 or 1)
    x[3, 2, 0] = -qm * 2.0                        # scale 2.0
    x[3, 2, 1:5] = [1.0, 3.0, -5.0, 7.0]          # x/s = ±0.5, 1.5, 2.5, 3.5
    return x


@pytest.mark.parametrize("bits", range(1, 9))
def test_quantize_codes_exactly_equal_reference(bits):
    x = _inputs(bits)
    jc, js = jq.quantize(jnp.asarray(x), bits)
    tc, ts = tq.quantize(torch.as_tensor(x), bits)
    assert tc.dtype == torch.int8
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    # the 1-bit scale is a mean, summed in another order: a few ulp
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    qc, qs = tq.quantize_query(torch.as_tensor(x), bits)
    np.testing.assert_array_equal(qc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("bits", [3, 8])
def test_quantize_bf16_input_and_dequantize_match_reference(bits):
    x = _inputs(bits, seed=5)
    jx = jnp.asarray(x, jnp.bfloat16)
    tx = torch.as_tensor(x).to(torch.bfloat16)
    jc, js = jq.quantize(jx, bits)
    tc, ts = tq.quantize(tx, bits)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tq.dequantize(tc, ts).numpy(),
                               np.asarray(jq.dequantize(jc, js)),
                               rtol=1e-6, atol=0)


def test_qmax_for_bits_matches_reference():
    assert [tq.qmax_for_bits(b) for b in range(1, 9)] == \
        [jq.qmax_for_bits(b) for b in range(1, 9)]
