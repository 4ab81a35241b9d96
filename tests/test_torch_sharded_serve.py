"""The lane-sharded `ServeLoop(mesh=...)` of the port, single process, every
shard on the CPU.

On `tests/test_sharded_serve.py`'s trace (reduced granite-3-2b, its
`PRUNE`, ten staggered requests, every third sampled with a pinned seed),
`ServeLoop(mesh=2)` and `ServeLoop(mesh=4)` on 4 lanes stream every greedy
request token-identical to the reference's unsharded
`ServeLoop(window=None)` (f32 weights on both sides,
`tests/torch_parity.py`), and every request, the seeded sampled ones
included, identical to the port's own unsharded loop (the port's sampled
streams are its own: torch cannot reproduce jax.random). Then the
reference test's claims on the port: shard-local free-lane accounting and
grouped admission into one shard, per-shard token counters that partition
the total, the most-free-shard rule, a preempted lane resuming token-
identical (a greedy victim to the reference's solo loop, a sampled one to
the port's), `mesh=3` on 4 lanes refused; and with a mesh the prefix
cache, chunked admission and a chaos blackout of one shard leave the
streams unchanged.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import SamplingParams as JaxSampling  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro_torch.launch.mesh import LaneMesh, make_serve_mesh  # noqa: E402
from repro_torch.launch.serve import (Request, SamplingParams,  # noqa: E402
                                      ServeLoop)
from repro_torch.runtime.chaos import ChaosConfig  # noqa: E402
from torch_parity import model_pair  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

PRUNE = dict(heavy=48, reserve=16, select_k=16, sink_tokens=2,
             recent_window=8)
LANES = 4


@functools.lru_cache(maxsize=None)
def _pair():
    return model_pair("granite-3-2b", **PRUNE)


def _prompt(vocab, t, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, t)


def _mixed(vocab, n=10, sampling=SamplingParams):
    """test_sharded_serve.py's staggered trace with its greedy/sampled
    mix."""
    reqs = []
    for i in range(n):
        kw = dict(prompt=_prompt(vocab, 5 + (7 * i) % 26, seed=i),
                  max_new=3 + i % 10)
        if i % 3 == 0:
            kw["sampling"] = sampling(temperature=0.8, top_k=5)
            kw["sample_seed"] = 100 + i
        reqs.append(kw)
    return reqs


def _port_replay(mesh, lanes=LANES, reqs=None, **kw):
    _, _, tm, tp = _pair()
    loop = ServeLoop(tm, tp, lanes=lanes, eos=-1, block=4, mesh=mesh,
                     device="cpu", **kw)
    hs = [loop.submit(Request(**r)) for r in (reqs or _mixed(
        tm.cfg.vocab_size))]
    loop.run()
    return [h.tokens for h in hs], loop


@functools.lru_cache(maxsize=None)
def _reference_streams():
    jm, jp, tm, _ = _pair()
    loop = JaxServeLoop(jm, jp, lanes=LANES, eos=-1, block=4, window=None)
    hs = [loop.submit(JaxRequest(**r))
          for r in _mixed(tm.cfg.vocab_size, sampling=JaxSampling)]
    loop.run()
    return tuple(tuple(h.tokens) for h in hs)


@functools.lru_cache(maxsize=None)
def _unsharded_streams():
    return tuple(tuple(t) for t in _port_replay(None)[0])


@pytest.mark.parametrize("shards", [2, 4])
def test_sharded_replay_matches_the_reference_unsharded(shards):
    toks, loop = _port_replay(shards)
    assert loop.shards == shards and loop.lanes_per_shard == LANES // shards
    ref = _reference_streams()
    greedy = [i for i in range(len(toks)) if i % 3]
    assert [toks[i] for i in greedy] == [list(ref[i]) for i in greedy]
    assert [tuple(t) for t in toks] == list(_unsharded_streams())
    assert all(len(t) == 3 + i % 10 for i, t in enumerate(toks))


def test_mesh_from_int_and_validation():
    _, _, tm, tp = _pair()
    loop = ServeLoop(tm, tp, lanes=2 * LANES, mesh=LANES, device="cpu")
    assert loop.shards == LANES and loop.lanes_per_shard == 2
    loop = ServeLoop(tm, tp, lanes=LANES, mesh=LaneMesh(["cpu", "cpu"]),
                     device="cpu")
    assert loop.shards == 2
    with pytest.raises(AssertionError):
        ServeLoop(tm, tp, lanes=LANES, mesh=3, device="cpu")
    with pytest.raises(AttributeError):
        loop.state                            # one state a shard
    assert loop.mesh.devices == [torch.device("cpu")] * 2


def test_shard_free_lane_accounting():
    _, _, tm, tp = _pair()
    v = tm.cfg.vocab_size
    loop = ServeLoop(tm, tp, lanes=2 * LANES, eos=-1, block=4,
                     mesh=make_serve_mesh(LANES, device="cpu"), device="cpu")
    free = loop.shard_free_lanes()
    assert len(free) == LANES
    assert sorted(lane for fs in free for lane in fs) == list(
        range(2 * LANES))
    assert all(lane // loop.lanes_per_shard == i
               for i, fs in enumerate(free) for lane in fs)
    # a same-bucket pair admits as ONE group inside one shard's rows
    hs = [loop.submit(Request(prompt=_prompt(v, 16, s), max_new=8))
          for s in range(2)]
    loop.schedule()
    lanes = np.flatnonzero(loop.active)
    assert len(lanes) == 2
    assert len({int(lane) // loop.lanes_per_shard for lane in lanes}) == 1
    assert loop.counters["grouped_admissions"] == 1
    loop.run()
    agg = loop.aggregate()
    assert agg["shards"] == LANES
    total = sum(agg[f"shard{i}_tokens"] for i in range(LANES))
    assert total == sum(len(h.tokens) for h in hs) == agg["tokens"]
    assert agg["tokens_per_dispatch"] == pytest.approx(
        total / loop.counters["decode_blocks"])
    assert all(agg[f"shard{i}_tok_s"] >= 0 for i in range(LANES))
    # the shards' states live apart, one lanes_per_shard batch each
    assert all(st.kv.k.shape[1] == 2 for st in loop.shard_states)
    assert all(t.shape == (2,) for t in loop.shard_toks)


def test_admission_fills_the_most_free_shard():
    _, _, tm, tp = _pair()
    v = tm.cfg.vocab_size
    loop = ServeLoop(tm, tp, lanes=2 * LANES, eos=-1, block=4,
                     mesh=LANES, device="cpu")
    for s in range(2 * LANES):
        loop.submit(Request(prompt=_prompt(v, 16, s), max_new=8))
    loop.schedule()
    per_shard = np.asarray(loop.active).reshape(LANES, -1).sum(axis=1)
    assert per_shard.sum() > 0
    assert per_shard.max() - per_shard.min() <= loop.lanes_per_shard
    loop.run()
    assert all(len(loop.stats[r].tokens) == 8 for r in loop.stats)
    # most-free first, lowest index on ties: one request lands on shard 0,
    # the next on shard 1
    loop = ServeLoop(tm, tp, lanes=LANES, eos=-1, block=4, mesh=2,
                     device="cpu", group_admit=False)
    for s in range(2):
        loop.submit(Request(prompt=_prompt(v, 16 + s, s), max_new=4))
    loop.schedule()
    assert [loop.stats[r].lane // 2 for r in sorted(loop.stats)] == [0, 1]


def _preempted(victim, mesh):
    """The reference test's preemption trace: the victim and lanes - 1
    others fill the lanes, one block decodes, a priority-5 arrival
    preempts the victim."""
    _, _, tm, tp = _pair()
    v = tm.cfg.vocab_size
    loop = ServeLoop(tm, tp, lanes=LANES, eos=-1, block=4, mesh=mesh,
                     device="cpu")
    h_v = loop.submit(Request(**victim))
    for s in range(LANES - 1):
        loop.submit(Request(prompt=_prompt(v, 16, 90 + s), max_new=12,
                            priority=1))
    loop.schedule()
    loop._step_block()
    loop.submit(Request(prompt=_prompt(v, 16, 80), max_new=4, priority=5))
    loop.run()
    assert loop.counters["preemptions"] == 1
    assert h_v.stats.preemptions == 1
    return h_v.tokens


@pytest.mark.parametrize("shards", [2, 4])
def test_preempted_greedy_lane_resumes_as_the_reference_solo(shards):
    jm, jp, tm, tp = _pair()
    v = tm.cfg.vocab_size
    victim = dict(prompt=_prompt(v, 16, 1), max_new=12, priority=0)
    solo = JaxServeLoop(jm, jp, lanes=1, block=4, eos=-1, window=None)
    h_ref = solo.submit(JaxRequest(**victim))
    solo.run()
    toks = _preempted(victim, shards)
    assert toks == list(h_ref.tokens) and len(toks) == 12


@pytest.mark.parametrize("shards", [2, 4])
def test_preempted_sampled_lane_resumes_token_identical(shards):
    _, _, tm, tp = _pair()
    v = tm.cfg.vocab_size
    victim = dict(prompt=_prompt(v, 16, 1), max_new=12, priority=0,
                  sampling=SamplingParams(temperature=0.9, top_k=8),
                  sample_seed=13)
    solo = ServeLoop(tm, tp, lanes=1, block=4, eos=-1, device="cpu")
    h = solo.submit(Request(**victim))
    solo.run()
    assert _preempted(victim, shards) == h.tokens


def test_prefix_cache_and_chunked_admission_under_a_mesh():
    """With a mesh, sliced prefills (chunk 16) and the prefix cache (a
    repeated prompt hits exactly) stream as without one."""
    _, _, tm, _ = _pair()
    v = tm.cfg.vocab_size
    reqs = [dict(prompt=_prompt(v, n, s), max_new=m)
            for n, s, m in ((40, 1, 6), (12, 2, 5), (40, 1, 7), (33, 3, 4),
                            (12, 2, 3), (20, 4, 6))]
    kw = dict(chunk_prefill=16, prefix_cache_bytes=64 << 20)
    plain, _ = _port_replay(None, reqs=reqs, **kw)
    sharded, loop = _port_replay(2, reqs=reqs, **kw)
    assert sharded == plain
    assert loop.counters["chunk_dispatches"] > 0
    assert loop.counters["prefix_exact_hits"] > 0


def test_blackout_of_one_shard_routes_admission_around_it():
    _, _, tm, _ = _pair()
    reqs = _mixed(tm.cfg.vocab_size)
    plain, _ = _port_replay(None, reqs=reqs)
    chaos = ChaosConfig(blackout_shard=1, blackout_rounds=(0, 4))
    toks, loop = _port_replay(2, reqs=reqs, chaos=chaos)
    assert toks == plain
    assert loop.counters["chaos_blackouts"] == 1
    early = [s for s in loop.stats.values() if s.admit_seq < 2]
    assert early and all(s.lane < loop.lanes_per_shard for s in early)
