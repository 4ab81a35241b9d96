"""The training substrate in the port against the reference's: schedules,
AdamW (f32 and int8 moments), gradient compression with error feedback,
the data sources and pipeline, and the checkpoint manager.

Tolerances: the schedules within two f32 ulps, or 1e-7 of the peak rate
where the cosine nears zero (XLA's and torch's cos differ in the last
bits); AdamW over three steps of random gradients, leaf by leaf:
parameters within 1e-6 relative and f32 moments within 1e-6 of their
leaf's largest (the same f32 operations in the same order; the global
norm's sum order and pow's last bit apart, and m = b1 m + (1 - b1) g
cancels to small values that keep those absolute errors), int8 codes
at most one apart and equal but for at most 1% of them (a value that
close to a code's .5 rounding boundary rounds either way), scales within
1e-6 relative;
`compress_with_feedback`: codes exactly, residuals within 1e-6;
`SyntheticSource` and `MemmapSource`: bit for bit. The checkpoint tests
mirror `tests/test_substrate.py`'s round trip, retention and atomic
commit, and add a bf16 leaf restored bit for bit, a training state with
int8 moments, the asynchronous write and the on-disk layout.
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro.optim import schedule as jsched
from repro_torch.checkpoint.manager import CheckpointManager, spec_like
from repro_torch.data.pipeline import DataPipeline, MemmapSource, \
    SyntheticSource
from repro_torch.launch.train import TrainState
from repro_torch.optim import adamw, compression, schedule
from repro_torch.tree import leaves, tree_map

jax.config.update("jax_platform_name", "cpu")


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


# ---------------------------------------------------------------------------
# schedules
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.1), (0, 50, 0.0),
                                                (100, 60, 0.1)])
def test_warmup_cosine_matches_reference(warmup, total, floor):
    steps = np.arange(0, total + 20, dtype=np.int32)
    want = np.asarray(jsched.warmup_cosine(jnp.asarray(steps), 3e-4, warmup,
                                           total, floor))
    got = _np(schedule.warmup_cosine(torch.as_tensor(steps), 3e-4, warmup,
                                     total, floor))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2 ** -22, atol=1e-7 * 3e-4)
    assert got[0] > 0                         # step 0 is never a no-op
    one = schedule.warmup_cosine(3, 3e-4, warmup, total, floor)
    assert float(one) == pytest.approx(float(got[3]), rel=1e-7)


def test_constant_schedule():
    got = schedule.constant(torch.tensor(7, dtype=torch.int32), 2e-3)
    want = jsched.constant(jnp.asarray(7, jnp.int32), 2e-3)
    assert got.dtype == torch.float32 and float(got) == float(want)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _tree(seed, shapes=None):
    rng = np.random.default_rng(seed)
    shapes = shapes or {"embed": (7, 5), "b": {"w": (5,), "wo": (3, 4, 5)},
                        "shared": [(5, 6), (6,)]}

    def make(s):
        if isinstance(s, dict):
            return {k: make(v) for k, v in s.items()}
        if isinstance(s, list):
            return [make(v) for v in s]
        return rng.standard_normal(s).astype(np.float32)
    return make(shapes)


def _to_torch(tree):
    return tree_map(torch.from_numpy, tree)


def _jax_moment_leaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda t: isinstance(
        t, jadamw.QTensor))


@pytest.mark.parametrize("quantized", [False, True])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_adamw_update_matches_reference_leaf_by_leaf(quantized, clip):
    cfg_kw = dict(lr=1e-2, grad_clip=clip, quantized_state=quantized)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    params = _tree(0)
    jp = jax.tree.map(jnp.asarray, params)
    tp = _to_torch(params)
    js, ts = jadamw.init(jp, jcfg), adamw.init(tp, tcfg)
    for step in range(3):
        grads = _tree(10 + step)
        lr = jsched.warmup_cosine(js.step, 1e-2, 2, 10)
        jp, js = jadamw.update(jax.tree.map(jnp.asarray, grads), js, jp,
                               jcfg, lr)
        tp, ts = adamw.update(_to_torch(grads), ts, tp, tcfg,
                              schedule.warmup_cosine(ts.step, 1e-2, 2, 10))
        assert int(ts.step) == int(js.step) == step + 1
        for a, b in zip(leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        for tm, jm in ((ts.m, js.m), (ts.v, js.v)):
            for a, b in zip(adamw.moment_leaves(tm), _jax_moment_leaves(jm)):
                if not quantized:
                    np.testing.assert_allclose(
                        _np(a), np.asarray(b), rtol=1e-6,
                        atol=1e-6 * np.abs(np.asarray(b)).max())
                    continue
                assert a.q.dtype == torch.int8
                qa, qb = _np(a.q).astype(int), np.asarray(b.q).astype(int)
                np.testing.assert_allclose(_np(a.scale), np.asarray(b.scale),
                                           rtol=1e-6)
                assert np.abs(qa - qb).max() <= 1
                assert (qa != qb).mean() <= 0.01


def test_adamw_global_norm_and_quantized_bytes():
    tree = _tree(3)
    want = float(jadamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert float(adamw.global_norm(_to_torch(tree))) == pytest.approx(
        want, rel=1e-6)
    params = {"w": torch.zeros((64, 256))}
    st = adamw.init(params, adamw.AdamWConfig(quantized_state=True))
    q = st.m["w"]
    per_param = 2 * (q.q.numel() + 4 * q.scale.numel()) / 64 / 256
    assert q.q.dtype == torch.int8 and per_param == pytest.approx(2.03125)


def test_adamw_writes_in_place():
    params = _to_torch(_tree(4))
    before = [p.data_ptr() for p in leaves(params)]
    st = adamw.init(params, adamw.AdamWConfig())
    out, st2 = adamw.update(_to_torch(_tree(5)), st, params,
                            adamw.AdamWConfig())
    assert out is params and st2.m is st.m
    assert [p.data_ptr() for p in leaves(out)] == before


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_compress_with_feedback_matches_reference():
    grads = _tree(6)
    jef = jcomp.init_error_feedback(jax.tree.map(jnp.asarray, grads))
    tef = compression.init_error_feedback(_to_torch(grads))
    for step in range(3):
        g = _tree(20 + step)
        (jq, js), jef = jcomp.compress_with_feedback(
            jax.tree.map(jnp.asarray, g), jef)
        (tq, ts), tef = compression.compress_with_feedback(_to_torch(g), tef)
        for a, b in zip(leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(_np(a), np.asarray(b))
        for a, b in zip(leaves(ts), jax.tree.leaves(js)):
            np.testing.assert_allclose(_np(a), np.asarray(b), rtol=1e-7)
        for a, b in zip(leaves(tef.residual),
                        jax.tree.leaves(jef.residual)):
            np.testing.assert_allclose(_np(a), np.asarray(b), atol=1e-6)
    q, s = compression.quantize_grad(torch.zeros(3, 4))
    assert not q.any() and float(s.min()) == pytest.approx(1e-20)
    np.testing.assert_array_equal(
        _np(compression.dequantize_grad(q, s)), np.zeros((3, 4)))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,step", [(0, 0), (0, 17), (3, 5), (11, 999)])
def test_synthetic_source_is_bit_equal(seed, step):
    a = SyntheticSource(1000, 48, seed=seed).batch(step, 4)
    b = jpipe.SyntheticSource(1000, 48, seed=seed).batch(step, 4)
    assert a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)


def test_memmap_source_matches_reference(tmp_path):
    path = str(tmp_path / "toks.bin")
    np.arange(10000, dtype=np.uint16).tofile(path)
    a = MemmapSource(path, seq_len=64).batch(3, 5)
    np.testing.assert_array_equal(a, jpipe.MemmapSource(path, 64).batch(3, 5))
    assert (np.diff(a, axis=1) == 1).all()


def test_pipeline_prefetch_shard_slice_and_extras():
    src = SyntheticSource(50, 16, seed=0)
    pipe = DataPipeline(src, global_batch=8, process_index=1,
                        process_count=2, start_step=3, device="cpu",
                        extras={"w": lambda s, b: np.full((b, 2), s)})
    for step in (3, 4):
        batch = next(pipe)
        assert batch["tokens"].shape == (4, 16)
        assert batch["tokens"].device.type == "cpu"
        np.testing.assert_array_equal(_np(batch["tokens"]),
                                      src.batch(step, 8)[4:])
        assert (_np(batch["w"]) == step).all()
    assert pipe.step == 5
    pipe.close()


def test_pipeline_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    with pytest.raises(RuntimeError, match="CUDA"):
        DataPipeline(SyntheticSource(50, 16), global_batch=2)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    state = {"w": torch.arange(6.0).reshape(2, 3),
             "opt": {"m": torch.ones((4,)), "step": torch.tensor(3)}}
    for s in (10, 20, 30):
        mgr.save(s, tree_map(lambda x: x + s, state), block=True)
    assert mgr.all_steps() == [20, 30]       # retention pruned step 10
    out = mgr.restore(30, spec_like(state))
    np.testing.assert_allclose(_np(out["w"]), _np(state["w"]) + 30)
    assert out["opt"]["step"].dtype == torch.int64
    assert int(out["opt"]["step"]) == 33
    assert mgr.latest_step() == 30


def test_checkpoint_atomic_no_partial(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    mgr.save(5, {"w": torch.ones((8,))}, block=True)
    os.makedirs(tmp_path / "step_0000000009.tmp")   # a crash mid-write
    assert mgr.all_steps() == [5]
    assert mgr.restore_latest({"w": torch.zeros(8)})["w"].sum() == 8
    for name in os.listdir(tmp_path):
        assert not name.endswith(".tmp") or name.startswith("step_0000000009")


def test_checkpoint_bf16_and_int8_state_bit_for_bit(tmp_path):
    gen = torch.Generator().manual_seed(0)
    params = {"embed": torch.randn((9, 4), generator=gen).to(torch.bfloat16),
              "norm": {"w": torch.randn((4,), generator=gen)}}
    opt = adamw.init(params, adamw.AdamWConfig(quantized_state=True))
    opt.m["embed"].q.copy_(torch.randint(-127, 128, (9, 4), generator=gen))
    opt.m["embed"].scale.copy_(torch.rand((9, 1), generator=gen))
    state = TrainState(params, opt, torch.tensor(7, dtype=torch.int32))
    mgr = CheckpointManager(str(tmp_path), keep=1)
    mgr.save(7, state)
    mgr.wait()                                # the asynchronous write
    meta = json.load(open(tmp_path / "step_0000000007" / "tree.json"))
    dtypes = {leaf["path"]: leaf["dtype"] for leaf in meta["leaves"]}
    assert dtypes["params/embed"] == "bfloat16"
    assert dtypes["opt/m/embed/q"] == "int8"
    arrays = np.load(tmp_path / "step_0000000007" / "arrays.npz")
    assert len(arrays.files) == len(meta["leaves"])
    out = mgr.restore(7, state)
    assert isinstance(out, TrainState)
    assert isinstance(out.opt.m["embed"], adamw.QTensor)
    for a, b in zip(leaves(list(out)), leaves(list(state))):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert out.params["embed"].view(torch.int16).equal(
        params["embed"].view(torch.int16))


def test_checkpoint_write_failure_is_raised_and_not_committed(tmp_path,
                                                               monkeypatch):
    """A write that fails in the background thread is raised by the next
    wait (or save), and leaves no restorable step; a leaf count that does
    not match the target is refused."""
    mgr = CheckpointManager(str(tmp_path), keep=3)
    mgr.save(1, {"w": torch.ones(3)}, block=True)

    def full_disk(*args, **kwargs):
        raise OSError("no space left on device")
    monkeypatch.setattr(np, "savez", full_disk)
    mgr.save(2, {"w": torch.ones(3)})
    with pytest.raises(RuntimeError, match="write failed"):
        mgr.wait()
    mgr.wait()                               # the error is raised once
    assert mgr.all_steps() == [1]
    with pytest.raises(ValueError, match="leaves"):
        mgr.restore(1, {"w": torch.ones(3), "b": torch.ones(1)})
