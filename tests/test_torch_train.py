"""Training in the port against the reference's (`repro/launch/train.py`).

- one `make_train_step` of reduced granite-3-2b (dense), grok-1-314b
  (MoE), mamba2-1.3b (SSM), zamba2-7b (hybrid, 5 layers so the tail
  exists), whisper-base (enc-dec, a seeded `enc_embed`) and
  deepseek-v3-671b (MLA over one mla_dense and one mla_moe block, and the
  MTP head), with f32 and with int8 moments, on the same weights
  (`torch_parity.model_pair`) and the same `SyntheticSource` batch: loss,
  aux and (deepseek-v3) mtp_loss within 1e-5 relative,
  lr bit for bit, grad_norm within 1e-4 relative, and every updated
  parameter and f32 moment (int8 moments: the dequantized values) within
  the stated tolerance (below);
- `train_logits` of those models and of the frontend model
  llava-next-mistral-7b against the reference's (1e-4), and deepseek-v3's
  `train_outputs` with its "mtp_logits" (1e-4);
- with `loss_chunk` neither package takes an MTP loss;
- `chunked_cross_entropy` and `cross_entropy` against the reference's;
- the reference's `test_train_loss_decreases`,
  `test_fault_tolerant_loop_recovers` and `test_checkpoint_resume_bitexact`
  (`tests/test_integration.py`) on the port; the resumed run is held to
  the direct one bit for bit, a bf16 model's too;
- `remat=True` (both policies) gives the gradients of `remat=False`, and
  an unknown policy raises;
- the CLI runs, reduced deepseek-v3 too.

The updated parameters' tolerance. AdamW's first step moves a parameter
by lr · m̂ / (sqrt(v̂) + eps) + lr · wd · p, and m̂ / sqrt(v̂) = g / |g|: an
f32 gradient that differs between the two packages by its summation
order moves that ratio by eps · Δg / (|g| + eps)²: nothing where |g| is
a thousand times eps or more, but up to 2 where |g| is near eps = 1e-8
(measured: 0.33 lr at reduced zamba2-7b). So every parameter is held
within 2 · lr, and those whose gradient is at least 1e-5 (the
reference's m at least 1e-6) within 1e-5 · lr; both plus two ulps of the
parameter.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.launch import train as jtrain
from repro.optim import adamw as jadamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import get_config, reduced
from repro_torch.core import baselines
from repro_torch.data.pipeline import SyntheticSource
from repro_torch.launch import train
from repro_torch.models.transformer import Model
from repro_torch.optim import adamw
from repro_torch.runtime import fault
from repro_torch.tree import leaves, tree_map, unflatten

from torch_parity import model_pair, to_np

jax.config.update("jax_platform_name", "cpu")

PEAK_LR, WARMUP, TOTAL = 1e-3, 4, 20
PRUNE = dict(heavy=48, reserve=16, select_k=16, sink_tokens=2,
             recent_window=8)
ARCHS = {"granite-3-2b": {}, "grok-1-314b": {}, "mamba2-1.3b": {},
         "zamba2-7b": {"num_layers": 5}, "whisper-base": {},
         "deepseek-v3-671b": {}}


def _batch(cfg, step=0, b=2, t=24):
    batch = {"tokens": SyntheticSource(cfg.vocab_size, t, seed=3).batch(
        step, b), **train.frontend_inputs(cfg, step, b)}
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.as_tensor(v) for k, v in batch.items()})


def _pair_states(arch, quantized):
    jm, jp, tm, tp = model_pair(arch, "unicaim", cfg_kw=ARCHS[arch], **PRUNE)
    jcfg = jadamw.AdamWConfig(lr=PEAK_LR, quantized_state=quantized)
    tcfg = adamw.AdamWConfig(lr=PEAK_LR, quantized_state=quantized)
    js = jtrain.TrainState(jp, jadamw.init(jp, jcfg), jnp.zeros((),
                                                                jnp.int32))
    ts = train.TrainState(tp, adamw.init(tp, tcfg),
                          torch.zeros((), dtype=torch.int32))
    return jm, jcfg, js, tm, tcfg, ts


def _jax_leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _dequantized(xs):
    return [to_np(x.q).astype(np.float32) * to_np(x.scale)
            if isinstance(x, (jadamw.QTensor, adamw.QTensor)) else to_np(x)
            for x in xs]


def _jax_moments(tree):
    return _dequantized(jax.tree.leaves(
        tree, is_leaf=lambda t: isinstance(t, jadamw.QTensor)))


def _port_moments(tree):
    return _dequantized(adamw.moment_leaves(tree))


@pytest.mark.parametrize("quantized", [False, True],
                         ids=["f32_moments", "int8_moments"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_train_step_matches_reference(arch, quantized):
    jm, jcfg, js, tm, tcfg, ts = _pair_states(arch, quantized)
    jb, tb = _batch(tm.cfg)
    jstep = jax.jit(jtrain.make_train_step(jm, jcfg, TOTAL, peak_lr=PEAK_LR,
                                           warmup=WARMUP))
    tstep = train.make_train_step(tm, tcfg, TOTAL, peak_lr=PEAK_LR,
                                  warmup=WARMUP)
    p0 = [to_np(x).copy() for x in leaves(ts.params)]
    js1, jmet = jstep(js, jb)
    ts1, tmet = tstep(ts, tb)
    assert set(tmet) == set(jmet)
    assert ("mtp_loss" in tmet) == (arch == "deepseek-v3-671b")
    for k in ("loss", "aux") + (("mtp_loss",) if "mtp_loss" in tmet
                                else ()):
        np.testing.assert_allclose(to_np(tmet[k]), np.asarray(jmet[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    assert to_np(tmet["lr"]) == np.asarray(jmet["lr"])
    np.testing.assert_allclose(to_np(tmet["grad_norm"]),
                               np.asarray(jmet["grad_norm"]), rtol=1e-4)
    assert int(ts1.step) == int(js1.step) == 1
    assert int(ts1.opt.step) == int(js1.opt.step) == 1
    lr = float(jmet["lr"])
    got = [to_np(x) for x in leaves(ts1.params)]
    want = _jax_leaves(js1.params)
    assert len(got) == len(want)
    moved = 0
    for g, w, p, m in zip(got, want, p0, _jax_moments(js1.opt.m)):
        err = np.abs(g - w)
        ulps = 2 * np.spacing(np.abs(w))
        assert (err <= 2 * lr + ulps).all()
        # where |g| >= 1e-5 (|m| = 0.1 |g|), a thousand times eps, the
        # steps agree to 1e-5 lr and the parameter's rounding
        big = np.abs(m) >= 1e-6
        assert (err[big] <= 1e-5 * lr + ulps[big]).all()
        moved += int((np.abs(g - p) > 0).sum())
    assert moved > 0
    for name, tt, jt in (("m", ts1.opt.m, js1.opt.m),
                         ("v", ts1.opt.v, js1.opt.v)):
        gm, wm = _port_moments(tt), _jax_moments(jt)
        assert len(gm) == len(wm)
        for a, b in zip(gm, wm):
            # f32: the clipped gradient's sum order, and 1e-9 for the
            # leaves whose gradient is zero but for rounding noise (about
            # 1e-10: the key biases, to which a softmax is blind); int8: a
            # code may round the other way at a .5 boundary (one step of
            # its row's scale)
            top = np.abs(b).max(axis=-1, keepdims=True) if b.ndim else 0
            tol = 1e-5 * np.abs(b).max() + 1e-9 if not quantized \
                else top / 127 * 1.01 + 1e-9
            assert (np.abs(a - b) <= tol).all(), name


@pytest.mark.parametrize("arch", list(ARCHS) + ["llava-next-mistral-7b"])
def test_train_logits_match_reference(arch):
    jm, jp, tm, tp = model_pair(arch, "unicaim", cfg_kw=ARCHS.get(arch),
                                **PRUNE)
    jb, tb = _batch(tm.cfg, step=1, b=2, t=20)
    jl, jaux = jm.train_logits(jp, jb)
    tl, taux = tm.train_logits(tp, tb)
    assert tl.shape == jl.shape
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), atol=1e-4)
    np.testing.assert_allclose(to_np(taux), np.asarray(jaux), rtol=1e-5,
                               atol=1e-8)


def test_mtp_logits_match_reference():
    """deepseek-v3's `train_outputs`: the logits, the aux loss and the MTP
    head's logits (the pre-final-norm hidden beside the next token's
    embedding, through `mtp.proj`, an mla_dense block, `mtp.norm` and the
    head) against the reference's, 1e-4."""
    jm, jp, tm, tp = model_pair("deepseek-v3-671b", "unicaim", **PRUNE)
    jb, tb = _batch(tm.cfg, step=2, b=2, t=21)
    jo, to = jm.train_outputs(jp, jb), tm.train_outputs(tp, tb)
    assert set(to) == set(jo) == {"logits", "aux", "mtp_logits"}
    assert to["mtp_logits"].shape == (2, 20, tm.cfg.vocab_size)
    for k in ("logits", "mtp_logits"):
        np.testing.assert_allclose(to_np(to[k]), np.asarray(jo[k]),
                                   atol=1e-4, err_msg=k)
    np.testing.assert_allclose(to_np(to["aux"]), np.asarray(jo["aux"]),
                               rtol=1e-5, atol=1e-8)


def _port_state(like, jstate):
    """The reference's TrainState as the port's: its leaves (an int8
    moment's codes and scale in turn) in the port's tree order."""
    flat = iter(torch.as_tensor(np.array(x))
                for x in jax.tree.leaves(jstate))
    return unflatten(like, flat)


FIVE_STEP_METRICS = ("loss", "mtp_loss", "grad_norm")


def test_deepseek_five_steps_follow_the_reference():
    """Five steps of reduced deepseek-v3 (MTP head, int8 moments) on the
    schedule `chip_smoke.py`'s phase 14 runs (`total_steps=5`,
    `peak_lr=1e-3`, warmup 100: lr 1e-5 to 5e-5), each on its own batch,
    the same on both sides.

    Step by step: the port, started at each step from the reference's own
    state (weights, int8 moments, counters), takes that step with loss,
    mtp_loss and grad_norm within `test_train_step_matches_reference`'s
    tolerances (1e-5, 1e-4 relative). lr is held within one f32 ulp: the
    reference's jitted step divides by the warmup as XLA rewrites it (a
    product with the reciprocal), so 3e-5 comes out one ulp above the
    port's, which is the reference's eager value (`test_torch_optim.py`).

    Free-running, the two runs part by about 1e-4 relative at step 4: these
    steps amplify any rounding about a thousandfold (AdamW's first steps
    move each weight by about lr whatever the size of its gradient). The
    port run again from weights one ulp away parts from itself by as much,
    so each free-running metric is held within four times that drift plus
    the one-step tolerance."""
    jm, jcfg, js, tm, tcfg, ts = _pair_states("deepseek-v3-671b", True)
    jstep = jax.jit(jtrain.make_train_step(jm, jcfg, 5, peak_lr=PEAK_LR))
    tstep = train.make_train_step(tm, tcfg, 5, peak_lr=PEAK_LR)
    gen = torch.Generator().manual_seed(1)
    shaken = copy.deepcopy(ts)
    with torch.no_grad():
        for p in leaves(shaken.params):
            up = torch.nextafter(p, torch.full_like(p, float("inf")))
            p.copy_(torch.where(torch.rand(p.shape, generator=gen) < 0.5,
                                up, p))
    for i in range(5):
        jb, tb = _batch(tm.cfg, step=i)
        forced, fmet = tstep(_port_state(ts, js), tb)
        js, jmet = jstep(js, jb)
        ts, tmet = tstep(ts, tb)
        shaken, smet = tstep(shaken, tb)
        for k in FIVE_STEP_METRICS:
            rtol = 1e-4 if k == "grad_norm" else 1e-5
            want = float(np.asarray(jmet[k]))
            np.testing.assert_allclose(float(fmet[k]), want, rtol=rtol,
                                       atol=1e-7, err_msg=f"step {i} {k}")
            drift = abs(float(tmet[k]) - float(smet[k]))
            assert abs(float(tmet[k]) - want) <= (
                4 * drift + rtol * abs(want)), (i, k)
        for met in (fmet, tmet):
            np.testing.assert_allclose(to_np(met["lr"]),
                                       np.asarray(jmet["lr"]),
                                       rtol=2.0 ** -23, atol=0)
        assert int(forced.opt.step) == int(ts.opt.step) == i + 1
    assert int(js.opt.step) == 5


def test_loss_chunk_takes_no_mtp_loss():
    """With `loss_chunk` the reference projects the head from
    `train_hidden` and takes no MTP loss; the port neither: the same
    metrics and loss."""
    jm, jp, tm, tp = model_pair("deepseek-v3-671b", "unicaim", **PRUNE)
    jb, tb = _batch(tm.cfg, step=3)
    jl, jmet = jtrain.make_loss_fn(jm, loss_chunk=8)(jp, jb)
    tl, tmet = train.make_loss_fn(tm, loss_chunk=8)(tp, tb)
    assert set(tmet) == set(jmet) == {"loss", "aux"}
    np.testing.assert_allclose(to_np(tl), np.asarray(jl), rtol=1e-5)
    _, full = train.make_loss_fn(tm)(tp, tb)
    assert "mtp_loss" in full
    np.testing.assert_allclose(to_np(tmet["loss"]), to_np(full["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("t,chunk", [(24, 8), (23, 8), (24, 64)])
def test_chunked_cross_entropy_matches_reference(t, chunk):
    rng = np.random.default_rng(t + chunk)
    h = rng.standard_normal((2, t, 16)).astype(np.float32)
    head = rng.standard_normal((16, 50)).astype(np.float32)
    tg = rng.integers(0, 50, (2, t)).astype(np.int32)
    want = jtrain.chunked_cross_entropy(jnp.asarray(h), jnp.asarray(head),
                                        jnp.asarray(tg), chunk)
    got = train.chunked_cross_entropy(torch.from_numpy(h),
                                      torch.from_numpy(head),
                                      torch.from_numpy(tg), chunk)
    np.testing.assert_allclose(to_np(got), np.asarray(want), rtol=1e-6)
    logits = h @ head
    np.testing.assert_allclose(
        to_np(train.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(tg))),
        np.asarray(jtrain.cross_entropy(jnp.asarray(logits),
                                        jnp.asarray(tg))), rtol=1e-6)
    np.testing.assert_allclose(to_np(got), np.asarray(
        jtrain.cross_entropy(jnp.asarray(logits), jnp.asarray(tg))),
        rtol=1e-5)


def test_loss_chunk_gives_the_same_step():
    """`loss_chunk` projects the head chunk by chunk: the same loss and
    gradients as the materialised logits."""
    cfg = reduced(get_config("granite-3-2b"))
    model = Model(cfg, baselines.unicaim(**PRUNE), device="cpu")
    src = SyntheticSource(cfg.vocab_size, 24, seed=0)
    batch = {"tokens": torch.as_tensor(src.batch(0, 2))}
    outs = []
    for chunk in (0, 8):
        state = train.init_train_state(model, adamw.AdamWConfig(), 0)
        step = train.make_train_step(model, adamw.AdamWConfig(), 10,
                                     loss_chunk=chunk)
        state, m = step(state, batch)
        outs.append((m, [x.clone() for x in leaves(state.params)]))
    np.testing.assert_allclose(to_np(outs[0][0]["loss"]),
                               to_np(outs[1][0]["loss"]), rtol=1e-6)
    np.testing.assert_allclose(to_np(outs[0][0]["grad_norm"]),
                               to_np(outs[1][0]["grad_norm"]), rtol=1e-5)


# ---------------------------------------------------------------------------
# the reference's integration tests on the port
# ---------------------------------------------------------------------------


def _tiny(arch="granite-3-2b", dtype=None):
    cfg = reduced(get_config(arch))
    if dtype:
        cfg = reduced(get_config(arch), param_dtype=dtype,
                      compute_dtype=dtype)
    return cfg, Model(cfg, baselines.unicaim(**PRUNE), device="cpu")


def test_train_loss_decreases():
    cfg, model = _tiny()
    opt_cfg = adamw.AdamWConfig(lr=3e-3)
    state = train.init_train_state(model, opt_cfg, 0)
    step = train.make_train_step(model, opt_cfg, total_steps=60,
                                 peak_lr=3e-3, warmup=10)
    src = SyntheticSource(cfg.vocab_size, 64, seed=0)
    losses = []
    for i in range(60):
        state, m = step(state, {"tokens": torch.as_tensor(src.batch(i, 8))})
        losses.append(float(m["loss"]))
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3, \
        (losses[:5], losses[-5:])


def test_fault_tolerant_loop_recovers(tmp_path):
    cfg, model = _tiny()
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    state = train.init_train_state(model, opt_cfg, 0)
    step = train.make_train_step(model, opt_cfg, total_steps=40)
    src = SyntheticSource(cfg.vocab_size, 32, seed=0)
    ckpt = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    crashed = {"done": False}

    def inject(step_i):
        if step_i == 25 and not crashed["done"]:
            crashed["done"] = True
            raise RuntimeError("injected node failure")

    def data_iter(i):
        return {"tokens": torch.as_tensor(src.batch(i, 4))}

    state, stats = fault.run_training(
        step_fn=step, state=state, data_iter=data_iter, num_steps=40,
        ckpt=ckpt, fcfg=fault.FaultConfig(ckpt_every=10, max_restarts=2),
        inject_failure=inject)
    assert stats.restarts == 1
    assert int(state.opt.step) == 40         # resumed from 20, reached 40
    assert ckpt.latest_step() == 40
    assert stats.steps == 45                 # 25 + the 20 from step 20


def test_fault_loop_resumed_losses_equal_uninterrupted(tmp_path):
    """The losses after a restore equal the uninterrupted run's at the
    same steps, bit for bit (the step and the data are functions of their
    inputs), and too many failures raise."""
    cfg, model = _tiny()
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    src = SyntheticSource(cfg.vocab_size, 32, seed=0)

    def run(path, fail_at=(), max_restarts=3):
        failed = set()

        def inject(i):
            if i in fail_at and i not in failed:
                failed.add(i)
                raise RuntimeError("injected")
        losses = {}

        def on_metrics(i, m):
            losses.setdefault(i, []).append(float(m["loss"]))
        state, stats = fault.run_training(
            train.make_train_step(model, opt_cfg, total_steps=12),
            train.init_train_state(model, opt_cfg, 0),
            lambda i: {"tokens": torch.as_tensor(src.batch(i, 2))}, 12,
            CheckpointManager(str(path), keep=2),
            fault.FaultConfig(ckpt_every=4, max_restarts=max_restarts),
            inject_failure=inject, on_metrics=on_metrics)
        return losses, stats

    clean, s0 = run(tmp_path / "a")
    faulted, s1 = run(tmp_path / "b", fail_at=(9,))
    assert (s0.restarts, s1.restarts) == (0, 1)
    assert {i: v[0] for i, v in clean.items()} == {
        i: v[-1] for i, v in faulted.items()}
    assert len(faulted[8]) == 2 and len(faulted[7]) == 1
    with pytest.raises(RuntimeError, match="exceeded 1 restarts"):
        run(tmp_path / "c", fail_at=(2, 3), max_restarts=1)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoint_resume_bitexact(tmp_path, dtype):
    cfg, model = _tiny(dtype=dtype)
    opt_cfg = adamw.AdamWConfig(lr=1e-3)
    step = train.make_train_step(model, opt_cfg, total_steps=30)
    src = SyntheticSource(cfg.vocab_size, 32, seed=1)

    def run(n, state):
        for i in range(int(state.opt.step), n):
            state, _ = step(state, {"tokens": torch.as_tensor(
                src.batch(i, 4))})
        return state

    s_direct = run(20, train.init_train_state(model, opt_cfg, 0))
    s10 = run(10, train.init_train_state(model, opt_cfg, 0))
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(10, s10, block=True)
    s_resumed = run(20, mgr.restore(10, s10))
    for a, b in zip(leaves(s_direct.params),
                    leaves(s_resumed.params)):
        assert a.dtype == b.dtype
        assert torch.equal(a, b)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", ["granite-3-2b", "zamba2-7b",
                                  "whisper-base", "grok-1-314b",
                                  "deepseek-v3-671b"])
def test_remat_gives_the_same_gradients(arch, policy):
    cfg = reduced(get_config(arch), **ARCHS.get(arch, {}))
    with pytest.raises(ValueError, match="remat_policy"):
        Model(cfg, baselines.unicaim(**PRUNE), device="cpu",
              remat_policy="everything")
    _, tb = _batch(cfg)
    grads = []
    for remat in (False, True):
        model = Model(cfg, baselines.unicaim(**PRUNE), device="cpu",
                      remat=remat, remat_policy=policy)
        params = model.init(0)
        live = tree_map(lambda p: p.detach().requires_grad_(True),
                        params)
        loss, _ = train.make_loss_fn(model)(live, tb)
        grads.append(torch.autograd.grad(loss, leaves(live),
                                         allow_unused=True))
    for a, b in zip(*grads):
        if a is None:
            assert b is None
        else:
            torch.testing.assert_close(a, b, rtol=0, atol=1e-7)


def test_cli_trains_on_the_cpu(tmp_path, capsys):
    train.main(["--arch", "granite-3-2b", "--reduced", "--device", "cpu",
                "--steps", "12", "--batch", "2", "--seq", "16",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
                "--quantized-opt", "--remat"])
    out = capsys.readouterr().out
    assert "done: 12 steps, 0 restarts" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [10, 12]


def test_cli_trains_mla_on_the_cpu(tmp_path, capsys):
    """`--arch deepseek-v3-671b --reduced --device cpu`: MLA blocks, an MoE
    block and the MTP head's loss, with remat and int8 moments."""
    train.main(["--arch", "deepseek-v3-671b", "--reduced", "--device",
                "cpu", "--steps", "6", "--batch", "2", "--seq", "16",
                "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
                "--quantized-opt", "--remat"])
    out = capsys.readouterr().out
    assert "done: 6 steps, 0 restarts" in out
    assert CheckpointManager(str(tmp_path)).all_steps() == [5, 6]


def test_train_entry_points_raise_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--reduced", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(reduced(get_config("granite-3-2b")),
              baselines.unicaim(**PRUNE), remat=True)
