"""Fault-tolerant serving in the port's ServeLoop: deadlines, cancellation,
backpressure, the degrade ladder, NaN quarantine with retry, and the chaos
harness (`repro_torch.runtime.chaos`).

Reduced longchat-7b, f32 weights on both sides (`tests/torch_parity.py`),
bf16 and int8 KV where the case allows:
- against the reference: `ChaosConfig` masks, stalls, blackouts and
  `flood` bit for bit; the decode block's sentinel under one fault mask;
  and greedy traces through `ServeLoop(window=None)` and the port's loop
  (quarantine and retry, exhausted retries mid-block, cancel, shedding by
  priority, a flood, unservable shapes, the degrade ladder, a blackout)
  with equal tokens, outcomes, detail kinds, retries, admission order and
  fault counters;
- the port alone (its sampled streams are its own): greedy and seeded
  sampled retries replay the clean run, a loop-seeded retry draws the
  loop's stream once, an inert `ChaosConfig()` dispatches the same aten
  ops as none, a deadline under a stall frees its lane within one block
  (on a fake clock), a cancelled sliced prefill frees its reserved lane,
  and `_fail_stuck` resolves a queue that cannot be placed.
"""
import functools
import types
from collections import Counter

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro.launch.serve import _model_key, _prefill_fn  # noqa: E402
from repro.launch.serve import \
    decode_block_lanes as jax_decode_block_lanes  # noqa: E402
from repro.runtime import chaos as jchaos  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.serve import (Request, SamplingParams,  # noqa: E402
                                      ServeLoop, decode_block_lanes)
from repro_torch.runtime.chaos import ChaosConfig, flood  # noqa: E402
from torch_parity import model_pair, to_np  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PRUNE = dict(heavy=48, reserve=16, select_k=16, sink_tokens=2,
             recent_window=12)
VOCAB = reduced(get_config("longchat-7b")).vocab_size
TOP_K = SamplingParams(temperature=0.9, top_k=5)
TOP_P = SamplingParams(temperature=1.0, top_p=0.8)
BLOCK = 4
# the fault counters compared with the reference on every trace
FAULT_COUNTERS = ("quarantined_lanes", "retried_requests", "failed_requests",
                  "deadline_expired", "cancelled_requests",
                  "rejected_requests", "shed_requests", "degrade_down",
                  "degrade_up", "chaos_faults", "chaos_stalls",
                  "chaos_blackouts", "prefill_dispatches", "decode_blocks")


@functools.lru_cache(maxsize=None)
def _pair(kv):
    return model_pair("longchat-7b", kv_dtype=kv, fused=True, **PRUNE)


def _port(kv="bf16"):
    return _pair(kv)[2:]


def _prompt(t, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, t)


def _kind(detail: str) -> str:
    """The kind of a `RequestStats.detail` (the two packages word their
    max_new rejection differently)."""
    for kind in ("empty prompt", "max_new", "bucket", "queue full", "shed",
                 "expired", "non-finite", "no progress"):
        if kind in detail:
            return kind
    assert detail == "", detail
    return ""


def _both(kv, reqs, drive=None, **loop_kw):
    """Serve `reqs` (Request kwargs) through the reference ServeLoop
    (window=None) and the port's with the same loop knobs; `drive(loop,
    handles)` replaces `run()` → (jax loop, jax handles, port loop, port
    handles)."""
    jm, jp, tm, tp = _pair(kv)
    chaos = loop_kw.pop("chaos", None)
    out = []
    for loop, cls in (
            (JaxServeLoop(jm, jp, window=None, eos=-1, block=BLOCK,
                          chaos=_jax_chaos(chaos), **loop_kw), JaxRequest),
            (ServeLoop(tm, tp, eos=-1, block=BLOCK, chaos=chaos,
                       device="cpu", **loop_kw), Request)):
        hs = [loop.submit(cls(**r)) for r in reqs]
        if drive is None:
            loop.run()
        else:
            drive(loop, hs)
        out += [loop, hs]
    return out


def _jax_chaos(cfg):
    return None if cfg is None else jchaos.ChaosConfig(
        **{f: getattr(cfg, f) for f in cfg.__dataclass_fields__})


def _assert_same(jloop, jhs, tloop, ths, counters=FAULT_COUNTERS):
    assert [h.tokens for h in ths] == [h.tokens for h in jhs]
    assert [h.outcome for h in ths] == [h.outcome for h in jhs]
    assert ([_kind(h.stats.detail) for h in ths]
            == [_kind(h.stats.detail) for h in jhs])
    for field in ("retries", "admit_seq", "degraded"):
        assert ([getattr(h.stats, field) for h in ths]
                == [getattr(h.stats, field) for h in jhs]), field
    for name in counters:
        assert tloop.counters[name] == jloop.counters[name], name


# ---------------------------------------------------------------------------
# the chaos harness, bit for bit
# ---------------------------------------------------------------------------

CHAOS_GRID = [
    dict(seed=0, logit_fault_rate=0.3),
    dict(seed=3, logit_fault_rate=1.0, fault_blocks=(1,), fault_lanes=(0, 1)),
    dict(seed=7, logit_fault_rate=0.05, fault_blocks=(0, 2, 5),
         stall_blocks=(1, 4), stall_s=0.25),
    dict(seed=11, logit_fault_rate=0.6, fault_lanes=(2,), blackout_shard=0,
         blackout_rounds=(3, 9)),
    dict(),
]


@pytest.mark.parametrize("cfg", CHAOS_GRID, ids=range(len(CHAOS_GRID)))
def test_chaos_config_matches_reference(cfg):
    mine, ref = ChaosConfig(**cfg), jchaos.ChaosConfig(**cfg)
    assert mine.any_faults == ref.any_faults
    for block in range(8):
        assert mine.stall(block) == ref.stall(block)
        for steps, lanes in ((1, 3), (4, 3), (8, 4), (16, 7)):
            np.testing.assert_array_equal(mine.fault_mask(block, steps, lanes),
                                          ref.fault_mask(block, steps, lanes))
    for round_ in range(12):
        for shard in range(2):
            assert (mine.blacked_out(round_, shard)
                    == ref.blacked_out(round_, shard))
    for seed in range(3):
        a = flood(VOCAB, 5, length=12, max_new=3, priority=2, seed=seed,
                  arrival=0.5)
        b = jchaos.flood(VOCAB, 5, length=12, max_new=3, priority=2,
                         seed=seed, arrival=0.5)
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x.pop("prompt"), y.pop("prompt"))
            assert x == y


# ---------------------------------------------------------------------------
# the decode block's sentinel, against the reference's block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_sentinel_block_matches_reference(kv):
    """Three lanes, one of them idle, under one fault mask: the poisoned
    lanes stop before emitting at their poisoned step and are flagged;
    the clean lane's tokens, emissions and budget equal the reference's
    and the port's own clean block's."""
    jm, jp, tm, tp = _pair(kv)
    tokens = np.stack([_prompt(16, s) for s in (1, 2, 3)]).astype(np.int32)
    jlog, jst = _prefill_fn(_model_key(jm))(jp, {"tokens": jnp.asarray(tokens)})
    steps = 6
    fault = np.zeros((steps, 3), bool)
    fault[2, 0] = True                  # lane 0 poisoned at step 2
    fault[4:, 1] = True                 # lane 1 at steps 4 and 5
    fault[0, 2] = True                  # lane 2 is idle: no effect
    active = np.array([True, True, False])
    rem = np.array([9, 9, 0], np.int32)
    keys = np.zeros((3, 2), np.uint32)
    zeros = np.zeros(3, np.float32)
    tok0 = np.array(jnp.argmax(jlog, -1))
    out = jax_decode_block_lanes(
        jm, jp, jst, jnp.asarray(tok0), jnp.asarray(active),
        jnp.asarray(rem), jnp.asarray(np.full(3, -1, np.int32)), keys, zeros,
        np.zeros(3, np.int32), zeros, fault=fault, steps=steps)
    j_active, j_rem, _, j_poison, j_toks, j_emit = map(to_np, out[2:])

    def port(mask):
        _, tst = tm.prefill(tp, {"tokens": torch.as_tensor(tokens)})
        gens = [torch.Generator() for _ in range(3)]
        res = decode_block_lanes(
            tm, tp, tst, torch.as_tensor(tok0).long(),
            torch.as_tensor(active), torch.as_tensor(rem), -1, gens, zeros,
            np.zeros(3, np.int32), zeros, steps=steps, fault=mask)
        return [to_np(x) for x in res[2:]]

    t_active, t_rem, t_finite, t_toks, t_emit = port(fault)
    np.testing.assert_array_equal(t_emit, j_emit)
    np.testing.assert_array_equal(t_toks[t_emit], j_toks[j_emit])
    np.testing.assert_array_equal(t_active, j_active)
    np.testing.assert_array_equal(t_rem, j_rem)
    np.testing.assert_array_equal(active & ~t_finite, j_poison)
    assert list(active & ~t_finite) == [True, True, False]
    assert list(t_emit.sum(axis=0)) == [2, 4, 0]
    _, c_rem, c_finite, c_toks, c_emit = port(None)
    assert c_finite.all() and list(c_emit.sum(axis=0)) == [6, 6, 0]
    np.testing.assert_array_equal(c_toks[:, :2][t_emit[:, :2]],
                                  t_toks[:, :2][t_emit[:, :2]])


# ---------------------------------------------------------------------------
# traces against the reference ServeLoop
# ---------------------------------------------------------------------------

GREEDY = [dict(prompt=_prompt(16, 1), max_new=8),
          dict(prompt=_prompt(20, 2), max_new=8),
          dict(prompt=_prompt(24, 3), max_new=8)]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_quarantine_trace_equals_reference(kv):
    chaos = ChaosConfig(seed=3, logit_fault_rate=1.0, fault_blocks=(1,),
                        fault_lanes=(0, 1))
    jl, jh, tl, th = _both(kv, GREEDY, lanes=3, chaos=chaos)
    _assert_same(jl, jh, tl, th)
    clean = _serve(kv, GREEDY)[1]
    assert [h.tokens for h in th] == [h.tokens for h in clean]
    c = tl.counters
    assert c["quarantined_lanes"] == c["retried_requests"] == 2
    assert c["chaos_faults"] == 2 * BLOCK and c["failed_requests"] == 0
    assert c["nonfinite_lanes"] == 2
    assert [h.stats.retries for h in th] == [1, 1, 0]
    assert all(h.outcome == "done" and len(h.tokens) == 8 for h in th)


def _mid_block_seed(lanes, block=1, step=2, rate=0.3):
    """A seed whose fault mask on `lanes` lanes first hits lane 0 of
    `block` at `step`."""
    for seed in range(1000):
        col = ChaosConfig(seed=seed, logit_fault_rate=rate,
                          fault_blocks=(block,)).fault_mask(block, BLOCK,
                                                            lanes)[:, 0]
        if col.any() and int(np.argmax(col)) == step:
            return seed
    raise AssertionError("no seed")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_exhausted_retries_keep_the_clean_prefix(kv):
    """max_retries=0 and a fault at step 2 of block 1: the request fails
    with the 4 + 2 tokens emitted before the poisoned step, the
    reference's and the clean stream's prefix."""
    chaos = ChaosConfig(seed=_mid_block_seed(lanes=1), logit_fault_rate=0.3,
                        fault_blocks=(1,), fault_lanes=(0,))
    reqs = GREEDY[:1]
    jl, jh, tl, th = _both(kv, reqs, lanes=1, max_retries=0, chaos=chaos)
    _assert_same(jl, jh, tl, th)
    clean = _serve(kv, reqs, lanes=1)[1]
    assert th[0].outcome == "failed" and th[0].stats.retries == 1
    assert th[0].tokens == clean[0].tokens[:BLOCK + 2]
    assert tl.counters["failed_requests"] == 1


def test_cancel_active_and_queued_equals_reference():
    reqs = [dict(prompt=_prompt(16, s), max_new=m)
            for s, m in ((1, 64), (2, 8), (3, 4))]

    def drive(loop, hs):
        loop.schedule()
        loop._step_block()
        assert hs[0].cancel() and hs[1].cancel() and hs[1].cancel()
        loop.run()
        assert not hs[1].cancel()

    jl, jh, tl, th = _both("bf16", reqs, drive, lanes=1)
    _assert_same(jl, jh, tl, th)
    assert [h.outcome for h in th] == ["cancelled", "cancelled", "done"]
    assert len(th[0].tokens) == BLOCK and th[1].tokens == []
    assert tl.counters["cancelled_requests"] == 2


def test_backpressure_sheds_by_priority_equals_reference():
    reqs = [dict(prompt=_prompt(16, s), max_new=4) for s in range(4)]
    reqs.append(dict(prompt=_prompt(16, 9), max_new=4, priority=1))
    jl, jh, tl, th = _both("bf16", reqs, lanes=1, max_queue=2)
    _assert_same(jl, jh, tl, th)
    assert [h.outcome for h in th] == ["done", "rejected", "rejected",
                                       "rejected", "done"]
    assert [_kind(h.stats.detail) for h in th][1:4] == [
        "shed", "queue full", "queue full"]
    assert all(h.stats.retry_after >= 0.0 for h in th)
    assert tl.counters["shed_requests"] == 1


def test_flood_against_max_queue_equals_reference():
    reqs = flood(VOCAB, 8, length=16, max_new=4, seed=5)
    jl, jh, tl, th = _both("bf16", reqs, lanes=2, max_queue=3)
    _assert_same(jl, jh, tl, th)
    outcomes = [h.outcome for h in th]
    assert outcomes.count("done") == 3 and outcomes.count("rejected") == 5
    assert all(h.done for h in th)


def test_unservable_shapes_equal_reference():
    reqs = [dict(prompt=_prompt(16, 1), max_new=0),
            dict(prompt=np.zeros(0, np.int32), max_new=4),
            dict(prompt=_prompt(64, 2), max_new=4),
            dict(prompt=_prompt(16, 3), max_new=4)]
    jl, jh, tl, th = _both("bf16", reqs, lanes=1, buckets=(16, 32))
    _assert_same(jl, jh, tl, th)
    assert [h.outcome for h in th] == ["rejected"] * 3 + ["done"]
    assert [_kind(h.stats.detail) for h in th] == [
        "max_new", "empty prompt", "bucket", ""]
    assert all(h.tokens == [] for h in th[:3]) and len(th[3].tokens) == 4


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_degrade_ladder_equals_reference(kv):
    reqs = [dict(prompt=_prompt(16, s), max_new=16) for s in range(6)]
    jl, jh, tl, th = _both(kv, reqs, lanes=2, degrade=({"block": 2},),
                           degrade_high=2)
    _assert_same(jl, jh, tl, th)
    assert tl.counters["degrade_down"] >= 1 and tl.counters["degrade_up"] >= 1
    assert tl._degrade_level == 0
    clean = _serve(kv, reqs, lanes=2)[1]
    assert [h.tokens for h in th] == [h.tokens for h in clean]
    # the ladder's smaller blocks ran: fewer steps a block on average
    assert tl.counters["decode_steps"] < BLOCK * tl.counters["decode_blocks"]


def test_degrade_budget_cap_equals_reference():
    reqs = [dict(prompt=_prompt(16, s), max_new=12) for s in range(4)]
    jl, jh, tl, th = _both("bf16", reqs, lanes=1,
                           degrade=({"block": 2, "max_new_cap": 4},),
                           degrade_high=1, degrade_low=0)
    _assert_same(jl, jh, tl, th)
    capped = [h for h in th if h.stats.degraded]
    assert capped and all(h.outcome == "done" and len(h.tokens) == 4
                          for h in capped)
    assert len(th[0].tokens) == 12 and not th[0].stats.degraded


def test_one_shard_blackout_equals_reference():
    """Shard 0 is the whole port: rounds 1-5 hide every free lane, the
    loop sleeps through them (no `_fail_stuck`) and then serves all."""
    chaos = ChaosConfig(blackout_shard=0, blackout_rounds=(1, 6))
    jl, jh, tl, th = _both("bf16", GREEDY, lanes=2, chaos=chaos)
    _assert_same(jl, jh, tl, th)
    assert tl.counters["chaos_blackouts"] == 1
    assert all(h.outcome == "done" for h in th)
    assert min(h.stats.t_admit for h in th) > 0.004   # 5 sleeps of 1 ms


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------


def _serve(kv, reqs, lanes=3, **kw):
    model, params = _port(kv)
    loop = ServeLoop(model, params, lanes=lanes, eos=-1, block=BLOCK,
                     device="cpu", **kw)
    hs = [loop.submit(Request(**r)) for r in reqs]
    loop.run()
    return loop, hs


MIXED = [GREEDY[0],
         dict(prompt=_prompt(20, 2), max_new=8, sampling=TOP_K,
              sample_seed=7),
         dict(prompt=_prompt(24, 3), max_new=8, sampling=TOP_P,
              sample_seed=11)]


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_greedy_and_seeded_retries_replay_the_clean_run(kv):
    _, clean = _serve(kv, MIXED)
    chaos = ChaosConfig(seed=3, logit_fault_rate=1.0, fault_blocks=(1,),
                        fault_lanes=(0, 1, 2))
    loop, hs = _serve(kv, MIXED, chaos=chaos)
    assert loop.counters["quarantined_lanes"] == 3
    assert [h.stats.retries for h in hs] == [1, 1, 1]
    for h, ref in zip(hs, clean):
        assert h.outcome == "done" and h.tokens == ref.tokens


def test_loop_seeded_retry_draws_the_loop_stream_once():
    """Loop-level sampling, no pinned seeds: the request quarantined in
    block 1 replays its stream from its memoized seed, and the request
    admitted after it keeps its clean-run stream (a second draw would
    have shifted it)."""
    reqs = [dict(prompt=_prompt(16, s), max_new=8) for s in (1, 2, 3)]
    kw = dict(lanes=2, temperature=1.0, top_k=8, sample_seed=5)
    clean_loop, clean = _serve("bf16", reqs, **kw)
    chaos = ChaosConfig(seed=0, logit_fault_rate=1.0, fault_blocks=(1,),
                        fault_lanes=(0,))
    loop, hs = _serve("bf16", reqs, chaos=chaos, **kw)
    assert loop.counters["retried_requests"] == 1
    assert [h.tokens for h in hs] == [h.tokens for h in clean]
    assert torch.equal(loop._gen.get_state(), clean_loop._gen.get_state())


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_inert_chaos_dispatches_the_clean_ops():
    model, params = _port()
    blocks = {}
    for name, chaos in (("none", None), ("inert", ChaosConfig())):
        loop = ServeLoop(model, params, lanes=3, eos=-1, block=BLOCK,
                         chaos=chaos, device="cpu")
        hs = [loop.submit(Request(**r)) for r in MIXED]
        loop.schedule()
        ops = []
        for _ in range(2):
            with _Ops() as mode:
                loop._step_block()
            ops.append(mode.ops)
        blocks[name] = (ops, [h.tokens for h in hs], loop.counters)
    assert blocks["inert"] == blocks["none"]
    assert all(sum(ops.values()) > 0 for ops in blocks["none"][0])


class _FakeClock:
    """A clock that moves only when the loop sleeps (and a microsecond a
    reading), so a stall sets the deadline's clock whatever the host's
    load."""
    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 1e-6
        return self.t

    def sleep(self, s):
        self.t += s


def test_deadline_under_a_stall_frees_the_lane_within_one_block(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(serve, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, perf_counter=clock.monotonic,
        sleep=clock.sleep))
    model, params = _port()
    chaos = ChaosConfig(stall_blocks=(1,), stall_s=5.0)
    loop = ServeLoop(model, params, lanes=1, eos=-1, block=BLOCK,
                     chaos=chaos, device="cpu")
    dead = loop.submit(Request(prompt=_prompt(16, 1), max_new=64,
                               deadline_s=1.0))
    nxt = loop.submit(Request(prompt=_prompt(16, 2), max_new=4))
    loop.run()
    # expired during the stall before block 1; block 1 still ran, and the
    # next round's sweep freed the lane: exactly 2 blocks
    assert dead.outcome == "deadline" and len(dead.tokens) == 2 * BLOCK
    assert _kind(dead.stats.detail) == "expired"
    assert nxt.outcome == "done" and len(nxt.tokens) == 4
    assert nxt.stats.lane == 0 and nxt.stats.t_admit >= 5.0
    c = loop.counters
    assert c["deadline_expired"] == 1 and c["chaos_stalls"] == 1
    assert c["decode_blocks"] == 3


def test_queued_deadline_resolves_before_admission(monkeypatch):
    clock = _FakeClock()
    monkeypatch.setattr(serve, "time", types.SimpleNamespace(
        monotonic=clock.monotonic, perf_counter=clock.monotonic,
        sleep=clock.sleep))
    model, params = _port()
    loop = ServeLoop(model, params, lanes=1, eos=-1, block=BLOCK,
                     chaos=ChaosConfig(stall_blocks=(0,), stall_s=2.0),
                     device="cpu")
    first = loop.submit(Request(prompt=_prompt(16, 1), max_new=4))
    late = loop.submit(Request(prompt=_prompt(16, 2), max_new=4,
                               deadline_s=1.0))
    loop.run()
    assert first.outcome == "done"
    assert late.outcome == "deadline" and late.tokens == []
    assert "before admission" in late.stats.detail
    assert loop.counters["prefill_dispatches"] == 1


def test_cancelled_sliced_prefill_frees_its_reserved_lane():
    model, params = _port()
    loop = ServeLoop(model, params, lanes=1, eos=-1, block=BLOCK,
                     chunk_prefill=16, device="cpu")
    long = loop.submit(Request(prompt=_prompt(40, 1), max_new=4))
    loop.schedule()
    assert loop._pending is not None and loop._free_lanes() == []
    short = loop.submit(Request(prompt=_prompt(12, 2), max_new=4))
    assert loop._advance_chunked()
    assert long.cancel()
    assert not loop._advance_chunked()
    assert loop._pending is None and loop._free_lanes() == [0]
    assert long.outcome == "cancelled" and long.tokens == []
    loop.run()
    assert short.outcome == "done" and len(short.tokens) == 4
    assert loop.counters["chunk_dispatches"] == 1
    assert loop.counters["cancelled_requests"] == 1


def test_fail_stuck_resolves_a_queue_that_cannot_be_placed():
    model, params = _port()
    loop = ServeLoop(model, params, lanes=2, eos=-1, block=BLOCK,
                     device="cpu")
    loop._free_lanes = lambda: []          # nothing can ever be placed
    hs = [loop.submit(Request(prompt=_prompt(16, s), max_new=4))
          for s in (1, 2)]
    loop.run()
    assert [h.outcome for h in hs] == ["rejected", "rejected"]
    assert all(_kind(h.stats.detail) == "no progress" for h in hs)
    assert loop.counters["rejected_requests"] == 2
    assert loop._rounds == 3 and not loop.queue


def test_aggregate_carries_the_fault_counters():
    loop, hs = _serve("bf16", GREEDY[:2], lanes=1, max_queue=1)
    agg = loop.aggregate()
    assert agg["rejected_requests"] == 1.0
    for name in FAULT_COUNTERS:
        assert isinstance(agg[name], float), name
    assert [h.outcome for h in hs] == ["done", "rejected"]
