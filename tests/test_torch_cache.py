"""Parity of the port's cache with the reference: `prefill_fill` with and
without `length`, `write_token`'s slot choice (append, then argmin
eviction, and the streaming ring) and every field it writes, the lane
surgery, and `protected_mask`. Codes, valid and pos exactly; floats to
1e-6."""
import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import cache as jc  # noqa: E402
from repro_torch.core import cache as tc  # noqa: E402
from repro_torch.core.cache import FIELDS  # noqa: E402
from torch_parity import prune_pair, to_np  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

B, HK, D, N = 3, 2, 8, 30
UNICAIM = dict(heavy=12, reserve=4, select_k=4, sink_tokens=2,
               recent_window=4)


def assert_cache_equal(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = to_np(a), np.asarray(b)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32), atol=1e-6,
                                       rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


def _prefilled(policy, kv, length, **kw):
    """Both sides' caches after prefill_fill of the same random prompt."""
    kw = dict(UNICAIM, kv_dtype=kv) if policy == "unicaim" else kw
    jprune, tprune = prune_pair(policy, **kw)
    rng = np.random.default_rng(7)
    k = rng.standard_normal((B, HK, N, D)).astype(np.float32)
    v = rng.standard_normal((B, HK, N, D)).astype(np.float32)
    acc = rng.random((B, HK, N)).astype(np.float32)
    ln = None if length is None else np.asarray(length, np.int32)
    s = jprune.slots
    jcache = jc.prefill_fill(
        jc.init_cache(B, HK, D, s, jprune, jnp.float32),
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(acc), jprune,
        length=None if ln is None else jnp.asarray(ln))
    tcache = tc.prefill_fill(
        tc.init_cache(B, HK, D, s, tprune, torch.float32),
        torch.as_tensor(k), torch.as_tensor(v), torch.as_tensor(acc), tprune,
        length=None if ln is None else torch.as_tensor(ln))
    return jprune, tprune, jcache, tcache


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("length", [None, [30, 17, 9]])
def test_prefill_fill_matches_reference(kv, length):
    _, _, jcache, tcache = _prefilled("unicaim", kv, length)
    assert_cache_equal(tcache, jcache)


@pytest.mark.parametrize("policy,kw", [
    ("streaming", dict(budget=12, sinks=2)),
    ("h2o", dict(heavy=12, reserve=4, recent=4)),
])
def test_prefill_fill_baselines_match_reference(policy, kw):
    _, _, jcache, tcache = _prefilled(policy, None, [30, 17, 9], **kw)
    assert_cache_equal(tcache, jcache)


@pytest.mark.parametrize("policy,kv,kw", [
    ("unicaim", "bf16", {}), ("unicaim", "int8", {}),
    ("streaming", None, dict(budget=12, sinks=2)),
])
def test_write_token_sequence_matches_reference(policy, kv, kw):
    """Writes past a full cache: appends, then eviction (argmin of the
    accumulated score, first index on a tie, or the streaming ring)."""
    jprune, tprune, jcache, tcache = _prefilled(policy, kv, [30, 17, 9], **kw)
    rng = np.random.default_rng(11)
    for _ in range(2 * jprune.slots):
        kn = rng.standard_normal((B, HK, D)).astype(np.float32)
        vn = rng.standard_normal((B, HK, D)).astype(np.float32)
        jslot = np.asarray(jc._choose_slot(jcache, jprune))
        np.testing.assert_array_equal(to_np(tc._choose_slot(tcache, tprune)),
                                      jslot)
        jcache = jc.write_token(jcache, jnp.asarray(kn), jnp.asarray(vn),
                                jprune)
        # acc moves between writes, as decode steps would move it
        bump = 0.05 * rng.random((B, HK, jprune.slots)).astype(np.float32)
        jcache = jcache._replace(acc=jcache.acc + jnp.asarray(bump))
        tc.write_token(tcache, torch.as_tensor(kn), torch.as_tensor(vn),
                       tprune)
        tcache.acc += torch.as_tensor(bump)
        assert_cache_equal(tcache, jcache)


def test_write_token_active_mask_freezes_inactive_lanes():
    jprune, tprune, jcache, tcache = _prefilled("unicaim", "bf16", None)
    before = tcache.clone()
    kn = np.random.default_rng(2).standard_normal((B, HK, D)).astype(
        np.float32)
    jcache = jc.write_token(jcache, jnp.asarray(kn), jnp.asarray(kn), jprune)
    active = torch.tensor([True, False, True])
    tc.write_token(tcache, torch.as_tensor(kn), torch.as_tensor(kn), tprune,
                   active)
    for f in FIELDS:
        t = getattr(tcache, f)
        if t is None:
            continue
        np.testing.assert_array_equal(to_np(t[1]), to_np(getattr(before, f)[1]))
        for lane in (0, 2):
            np.testing.assert_allclose(
                to_np(t[lane]).astype(np.float32),
                np.asarray(getattr(jcache, f)[lane]).astype(np.float32),
                atol=1e-6, rtol=0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lane_surgery_matches_reference(kv):
    jprune, tprune, jcache, tcache = _prefilled("unicaim", kv, [30, 17, 9])
    _, _, jfresh, tfresh = _prefilled("unicaim", kv, [5, 30, 12])
    src = np.array([-1, 2, 0], np.int32)
    assert_cache_equal(tc.lanes_insert(tcache.clone(), src, tfresh),
                       jc.lanes_insert(jcache, jnp.asarray(src), jfresh))
    assert_cache_equal(tc.lane_reset(tcache.clone(), 1),
                       jc.lane_reset(jcache, 1))
    assert_cache_equal(tc.lane_slice(tcache, 2), jc.lane_slice(jcache, 2))
    # the layer-stacked form: lanes on axis 1
    tst = tcache.map(lambda a: torch.stack([a, a]))
    tc.lanes_insert(tst, src, tfresh.map(lambda a: torch.stack([a, a])),
                    batch_axis=1)
    assert_cache_equal(tst.layer(1), jc.lanes_insert(jcache, jnp.asarray(src),
                                                     jfresh))


def test_protected_mask_and_init_match_reference():
    jprune, tprune, jcache, tcache = _prefilled("unicaim", "bf16", [30, 17, 9])
    np.testing.assert_array_equal(
        to_np(tc.protected_mask(tcache, tprune)),
        np.asarray(jc.protected_mask(jcache, jprune)))
    for kv in ("bf16", "int8"):
        jp, tp = prune_pair("unicaim", **dict(UNICAIM, kv_dtype=kv))
        j = jc.init_cache(B, HK, D, jp.slots, jp, jnp.float32)
        t = tc.init_cache(B, HK, D, tp.slots, tp, torch.float32)
        assert_cache_equal(t, j)
        tl = tc.init_cache(B, HK, D, tp.slots, tp, torch.float32, layers=2)
        assert tl.k.shape == (2,) + tuple(t.k.shape)
        assert_cache_equal(tl.layer(1), j)
    assert dataclasses.fields(tc.KVCache)[0].name == "k"
    assert tuple(f.name for f in dataclasses.fields(tc.KVCache)) == \
        jc.KVCache._fields
