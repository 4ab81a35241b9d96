"""Parity of the port's selection modes with the reference: the threshold
race (the CAM discharge race) and blocked selection (`select_blocks > 1`,
the per-array race), fused and composed.

- `threshold_race` and `indices_to_mask` give the reference's masks
  exactly;
- 40 decode steps of `decode_attention` from one prefilled cache (appends,
  then eviction) track the reference's within 1e-5, out and the
  accumulated scores, bf16 and int8 KV;
- greedy tokens equal the reference's `greedy_generate` for reduced
  longchat-7b and granite-3-2b with `select_blocks` 2 and 4 (fused and
  composed) and with `select_mode="threshold"`;
- `ServeLoop` streams equal the reference `ServeLoop`'s on one arrival
  trace with `select_blocks=2`.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import attention as jattn  # noqa: E402
from repro.core import cache as jc  # noqa: E402
from repro.core import topk as jtopk  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro.launch.serve import greedy_generate as jax_greedy  # noqa: E402
from repro_torch.core import cache as tc  # noqa: E402
from repro_torch.core import topk  # noqa: E402
from repro_torch.core.attention import decode_attention  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from torch_parity import model_pair, prune_pair, to_np  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

# 24 + 8 = 32 slots: 2 blocks of 16 slots race for 4 winners each, 4 blocks
# of 8 slots for 2 each
PRUNE = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2, recent_window=8)
MODES = {
    "blocks2-fused": dict(select_blocks=2, fused=True),
    "blocks2-composed": dict(select_blocks=2, fused=False),
    "blocks4-fused": dict(select_blocks=4, fused=True),
    "blocks4-composed": dict(select_blocks=4, fused=False),
    "threshold": dict(select_mode="threshold"),
}


# ---------------------------------------------------------------------------
# the selection primitives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("iters", [8, 12])
@pytest.mark.parametrize("per_row_k", [False, True])
def test_threshold_race_mask_equals_reference(iters, per_row_k):
    rng = np.random.default_rng(iters + per_row_k)
    scores = rng.standard_normal((3, 4, 50)).astype(np.float32)
    scores[0, 0, 10:20] = scores[0, 0, 9]            # ties at the threshold
    eligible = rng.random((3, 4, 50)) < 0.7
    eligible[1, 2] = False                           # nothing eligible
    scores[2, 1, :5] = 1e30                          # sentinels, not eligible
    eligible[2, 1, :5] = False
    k = (rng.integers(1, 20, (3, 4, 1)).astype(np.int32) if per_row_k
         else 7)
    jk = jnp.asarray(k) if per_row_k else k
    tk = torch.as_tensor(k) if per_row_k else k
    for elig in (None, eligible):
        want = jtopk.threshold_race(
            jnp.asarray(scores), jk, iters,
            eligible=None if elig is None else jnp.asarray(elig))
        got = topk.threshold_race(
            torch.as_tensor(scores), tk, iters,
            eligible=None if elig is None else torch.as_tensor(elig))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not got[1, 2].any()


def test_indices_to_mask_equals_reference():
    idx = np.random.default_rng(0).integers(0, 30, (2, 3, 6))
    np.testing.assert_array_equal(
        topk.indices_to_mask(torch.as_tensor(idx), 30).numpy(),
        np.asarray(jtopk.indices_to_mask(jnp.asarray(idx), 30)))


# ---------------------------------------------------------------------------
# decode steps
# ---------------------------------------------------------------------------

B, HK, HQ, D, N = 3, 2, 4, 16, 30


@functools.lru_cache(maxsize=None)
def _jax_decode(prune):
    return jax.jit(functools.partial(jattn.decode_attention, prune=prune))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("mode", ["blocks2-fused", "blocks2-composed",
                                  "threshold"])
def test_decode_steps_track_reference(mode, kv):
    jprune, tprune = prune_pair("unicaim", kv_dtype=kv, **PRUNE,
                                **MODES[mode])
    rng = np.random.default_rng(3)
    k = rng.standard_normal((B, HK, N, D)).astype(np.float32)
    v = rng.standard_normal((B, HK, N, D)).astype(np.float32)
    acc = rng.random((B, HK, N)).astype(np.float32)
    length = np.array([30, 17, 9], np.int32)
    s = jprune.slots
    jcache = jc.prefill_fill(
        jc.init_cache(B, HK, D, s, jprune, jnp.bfloat16), jnp.asarray(k),
        jnp.asarray(v), jnp.asarray(acc), jprune, length=jnp.asarray(length))
    tcache = tc.prefill_fill(
        tc.init_cache(B, HK, D, s, tprune, torch.bfloat16),
        torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(acc), tprune,
        length=torch.as_tensor(length))
    step = _jax_decode(jprune)
    for i in range(40):
        q = rng.standard_normal((B, HQ, D)).astype(np.float32)
        kn = rng.standard_normal((B, HK, D)).astype(np.float32)
        vn = rng.standard_normal((B, HK, D)).astype(np.float32)
        jcache, jout = step(jcache, jnp.asarray(q), jnp.asarray(kn),
                            jnp.asarray(vn))
        tout = decode_attention(tcache, torch.as_tensor(q),
                                torch.as_tensor(kn), torch.as_tensor(vn),
                                tprune)
        np.testing.assert_allclose(to_np(tout), np.asarray(jout), atol=1e-5,
                                   rtol=0, err_msg=f"out, step {i}")
        np.testing.assert_allclose(to_np(tcache.acc), np.asarray(jcache.acc),
                                   atol=1e-5, rtol=0, err_msg=f"acc, step {i}")
    assert int(tcache.fill.min()) == s                # evicting by the end


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["longchat-7b", "granite-3-2b"])
def test_greedy_tokens_equal_reference(arch, mode):
    jm, jp, tm, tp = model_pair(arch, **PRUNE, **MODES[mode])
    rng = np.random.default_rng(5)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    tokens[1, 29:] = 0
    length = np.array([40, 29], np.int32)
    jtoks, _ = jax_greedy(jm, jp, {"tokens": jnp.asarray(tokens),
                                   "length": jnp.asarray(length)}, 16)
    ttoks, _ = greedy_generate(tm, tp, {"tokens": torch.as_tensor(tokens),
                                        "length": torch.as_tensor(length)},
                               16, device="cpu")
    np.testing.assert_array_equal(to_np(ttoks), to_np(jtoks))


def test_serve_streams_equal_reference_serve_loop_blocked():
    """One arrival trace through both ServeLoops with select_blocks=2. The
    reference runs full width (window=None), as the port always does: its
    windowed decode re-partitions the selection blocks over the window."""
    jm, jp, tm, tp = model_pair("longchat-7b", **PRUNE,
                                **MODES["blocks2-fused"])
    rng = np.random.default_rng(6)
    trace = [(rng.integers(0, tm.cfg.vocab_size, n), m)
             for n, m in zip([20, 9, 33, 17, 12], [6, 10, 4, 9, 3])]
    jloop = JaxServeLoop(jm, jp, lanes=3, block=4, window=None)
    tloop = ServeLoop(tm, tp, lanes=3, block=4, device="cpu")
    jh = [jloop.submit(JaxRequest(prompt=p, max_new=m)) for p, m in trace]
    th = [tloop.submit(Request(prompt=p, max_new=m)) for p, m in trace]
    jloop.run()
    tloop.run()
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert all(len(h.tokens) == m for h, (_, m) in zip(th, trace))
