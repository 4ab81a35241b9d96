"""The MoE family in the port (`repro_torch/models/moe.py`), against the
reference.

- `apply_moe` on the reference's `init_moe` weights: softmax gating,
  sigmoid gating with a shared expert, SwiGLU, GELU and relu² experts, a
  capacity factor low enough that tokens drop, and a zero router (every
  score tied: the lower expert wins, as in `lax.top_k`). The experts
  chosen and the dropped (token, choice) pairs are the reference's
  exactly, y within 1e-5 (f32), the aux loss within 1e-6.
- reduced grok-1-314b: prefill and teacher-forced decode logits to 1e-4
  and greedy tokens exactly, bf16 and int8 KV, fused and composed.
- `ServeLoop` greedy traces with grouped bucketed admission (a group of
  three padded to four rows, as the reference pads it: the rows share
  the experts' capacity) and with chunked admission: streams and
  counters equal the reference `ServeLoop(window=None)`'s, bf16 and int8
  KV.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from torch_parity import (decode_runs, model_pair, port_cfg,  # noqa: E402
                          to_np)

jax.config.update("jax_platform_name", "cpu")

ARCH = "grok-1-314b"
# (act, n_shared, capacity_factor, zero router)
MOE_CASES = {
    "softmax-swiglu": ("swiglu", 0, 1.25, False),
    "sigmoid-shared-swiglu": ("swiglu", 1, 1.25, False),
    "softmax-gelu": ("gelu", 0, 1.25, False),
    "sigmoid-shared-relu2": ("relu2", 1, 1.25, False),
    "softmax-relu2-drops": ("relu2", 0, 0.5, False),
    "sigmoid-shared-gelu-drops": ("gelu", 1, 0.4, False),
    "tied-scores-drops": ("swiglu", 0, 1.25, True),
}


def _moe_cfgs(act, n_shared, cf):
    base = jbase.reduced(jbase.get_config(ARCH))
    jcfg = jbase.reduced(jbase.get_config(ARCH), act=act,
                         moe=dataclasses.replace(base.moe, n_shared=n_shared,
                                                 capacity_factor=cf))
    return jcfg, port_cfg(jcfg)


def _reference_routing(jp, x, cfg):
    """The reference's own routing ops (`repro/models/moe.py:193-215`):
    its experts [T, k] and the (token, choice) pairs its capacity drops."""
    mo = cfg.moe
    n_tok = x.shape[0] * x.shape[1]
    cap = max(-(-int(n_tok * mo.top_k * mo.capacity_factor)
                // mo.n_experts), 8)
    cap = -(-cap // 8) * 8
    logits = jnp.asarray(x).reshape(n_tok, -1) @ jp["router"]
    scores = (jax.nn.sigmoid(logits) if mo.n_shared
              else jax.nn.softmax(logits, axis=-1))
    _, topi = jax.lax.top_k(scores, mo.top_k)
    flat = np.asarray(jnp.reshape(topi, -1))
    order = np.asarray(jnp.argsort(flat, stable=True))
    counts = np.bincount(flat, minlength=mo.n_experts)
    pos = np.arange(flat.size) - (np.cumsum(counts) - counts)[flat[order]]
    drop = np.zeros(flat.size, bool)
    drop[order] = pos >= cap
    return np.asarray(topi), drop.reshape(topi.shape)


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_apply_moe_matches_reference(case):
    act, n_shared, cf, tied = MOE_CASES[case]
    jcfg, tcfg = _moe_cfgs(act, n_shared, cf)
    tree = jax.tree.map(np.asarray, jmoe.init_moe(jax.random.PRNGKey(2),
                                                  jcfg, jnp.float32))
    if tied:
        tree["router"] = np.zeros_like(tree["router"])
    jp, tp = jax.tree.map(jnp.asarray, tree), from_reference(tree)
    x = np.random.default_rng(3).standard_normal((3, 20, 64)).astype(
        np.float32)
    jy, jaux = jmoe.apply_moe(jp, jnp.asarray(x), jcfg)
    ty, taux = moe.apply_moe(tp, torch.as_tensor(x), tcfg)

    mo = tcfg.moe
    _, _, topi = moe.route(tp, torch.as_tensor(x).reshape(60, 64), mo)
    drops = moe.dropped(topi, mo.n_experts, moe.capacity(60, mo))
    jtopi, jdrops = _reference_routing(jp, x, jcfg)
    np.testing.assert_array_equal(to_np(topi), jtopi)
    np.testing.assert_array_equal(to_np(drops), jdrops)
    if cf < 1 or tied:
        assert jdrops.any()                  # the capacity really binds
    else:
        assert not jdrops.any()
    if tied:                                  # the lower experts win ties
        assert (jtopi == np.arange(mo.top_k)).all()
    np.testing.assert_allclose(to_np(ty), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(taux), float(jaux), atol=1e-6, rtol=0)


def test_drops_are_recorded_without_a_host_sync():
    """`moe.DROPS` collects (token count, dropped pairs) per call while a
    caller holds a list there, as device tensors."""
    _, tcfg = _moe_cfgs("swiglu", 0, 0.5)
    tp = moe.init_moe(torch.Generator().manual_seed(0), tcfg, torch.float32,
                      "cpu")
    x = torch.randn((2, 24, 64), generator=torch.Generator().manual_seed(1))
    moe.DROPS = []
    try:
        moe.apply_moe(tp, x, tcfg)
        moe.apply_moe(tp, x[:, :3], tcfg)
        (n0, d0), (n1, d1) = moe.DROPS
    finally:
        moe.DROPS = None
    mo = tcfg.moe
    xt = x.reshape(48, 64)
    want = moe.dropped(moe.route(tp, xt, mo)[2], mo.n_experts,
                       moe.capacity(48, mo))
    assert (n0, n1) == (48, 6) and isinstance(d0, torch.Tensor)
    assert int(d0) == int(want.sum()) > 0 and int(d1) == 0


# ---------------------------------------------------------------------------
# reduced grok-1-314b, the model
# ---------------------------------------------------------------------------

UNICAIM = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2,
               recent_window=8)
TEACHER_STEPS, GREEDY_STEPS = 8, 16


@functools.lru_cache(maxsize=None)
def _runs(kv, fused):
    jm, jp, tm, tp = model_pair(ARCH, kv_dtype=kv, fused=fused, **UNICAIM)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, tm.cfg.vocab_size, (2, 40)).astype(np.int32)
    tokens[1, 29:] = 0                         # right-padded second prompt
    teacher = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (TEACHER_STEPS, 2)).astype(np.int32)
    return decode_runs(jm, jp, tm, tp,
                       {"tokens": tokens,
                        "length": np.array([40, 29], np.int32)},
                       teacher, GREEDY_STEPS)


MODEL_CASES = [(kv, f) for kv in ("bf16", "int8") for f in (True, False)]


@pytest.mark.parametrize("kv,fused", MODEL_CASES)
def test_moe_model_logits_match_reference(kv, fused):
    (jl, tl), _ = _runs(kv, fused)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv,fused", MODEL_CASES)
def test_moe_model_greedy_tokens_equal_reference(kv, fused):
    _, (jt, tt) = _runs(kv, fused)
    np.testing.assert_array_equal(tt, jt)


# ---------------------------------------------------------------------------
# ServeLoop
# ---------------------------------------------------------------------------

# buckets 16, 16, 16, 32, 64, 32, 64: on 4 lanes the first admission takes
# the three 16-token prompts in one group, padded to 4 rows. At capacity
# factor 1 the experts' capacity binds in every prompt pass, and the padded
# pass has more of it than 3 rows would (32 rows an expert, not 24): a loop
# that did not pad as the reference does gives other streams
SERVE_CF = 1.0
SERVE_LENS = [9, 12, 14, 20, 33, 17, 40]
SERVE_BUDGETS = [6, 10, 4, 9, 3, 7, 5]
COUNTERS = ("prefill_dispatches", "chunk_dispatches", "admit_dispatches",
            "grouped_admissions", "grouped_requests", "decode_blocks",
            "reservations", "reserved_admits")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("chunk", [0, 16])
def test_serve_loop_streams_equal_reference(kv, chunk):
    jm, jp, tm, tp = model_pair(ARCH, kv_dtype=kv, fused=True,
                                moe_kw=dict(capacity_factor=SERVE_CF),
                                **UNICAIM)
    rng = np.random.default_rng(4)
    trace = [(rng.integers(0, tm.cfg.vocab_size, n), m)
             for n, m in zip(SERVE_LENS, SERVE_BUDGETS)]
    jloop = JaxServeLoop(jm, jp, lanes=4, block=4, chunk_prefill=chunk,
                         window=None)
    tloop = ServeLoop(tm, tp, lanes=4, block=4, chunk_prefill=chunk,
                      device="cpu")
    jh = [jloop.submit(JaxRequest(prompt=p, max_new=m)) for p, m in trace]
    th = [tloop.submit(Request(prompt=p, max_new=m)) for p, m in trace]
    jloop.run()
    tloop.run()
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert ({c: tloop.counters[c] for c in COUNTERS}
            == {c: jloop.counters[c] for c in COUNTERS})
    if chunk:
        assert tloop.counters["chunk_dispatches"] > 0
    else:
        assert tloop.counters["grouped_requests"] >= 3
