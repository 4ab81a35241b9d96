"""Per-lane sampling knobs, priority preemption and drain-aware reservation
in the port's ServeLoop.

Reduced longchat-7b, f32 weights on both sides (`tests/torch_parity.py`),
bf16 and int8 KV:
- one greedy trace with priorities, a grouped admission, reservations, a
  preemption before the victim's first decode step (with a prefix cache,
  chunk 16 = `attn_chunk`) and a resumed sibling prompt, driven through
  the reference `ServeLoop(window=None)` and the port's with the same
  `schedule()`/`_step_block()` interleaving: tokens, admission order,
  per-request preemptions and the scheduler's counters are equal;
- the port alone (its streams are its own: torch cannot reproduce
  jax.random): greedy and seeded sampled victims resume token-identical to
  their uninterrupted runs; mixed greedy, top-k and top-p lanes reproduce
  each request's solo stream at the same lane count, on another lane and
  grouped (on the CPU an M = 1 product may take another kernel than M = 3,
  so a solo run keeps the lane count); an all-greedy loop leaves the loop
  generator and every lane carry untouched; a per-request stop token; the
  capture is a copy; a decoded victim never feeds the trie;
- mirrors of the reference's priority, reservation and
  `predicted_free_blocks` tests.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro_torch.configs.base import get_config, reduced  # noqa: E402
from repro_torch.launch.serve import (Request, SamplingParams,  # noqa: E402
                                      ServeLoop)
from torch_parity import model_pair  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

C = 16                                   # chunk_prefill == attn_chunk
PRUNE = dict(heavy=48, reserve=16, select_k=16, sink_tokens=2,
             recent_window=8)
TOP_K = SamplingParams(temperature=0.9, top_k=5)
TOP_P = SamplingParams(temperature=1.0, top_p=0.8)
VOCAB = reduced(get_config("longchat-7b")).vocab_size


@functools.lru_cache(maxsize=None)
def _pair(kv):
    return model_pair("longchat-7b", cfg_kw=dict(attn_chunk=C), kv_dtype=kv,
                      fused=True, **PRUNE)


def _port(kv="bf16"):
    return _pair(kv)[2:]


def _prompt(t, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, t)


def _loop(model, params, lanes, **kw):
    return ServeLoop(model, params, lanes=lanes, eos=-1, block=4,
                     device="cpu", **kw)


# ---------------------------------------------------------------------------
# against the reference ServeLoop
# ---------------------------------------------------------------------------

# (prompt, max_new, priority): submitted before the first schedule(), then
# after it (a priority-5 arrival that must preempt, and a prompt that
# extends the victim's prompt by one chunk)
FIRST = [(_prompt(16, 1), 10, 0), (_prompt(16, 2), 12, 1),
         (_prompt(12, 3), 6, 0), (_prompt(9, 4), 7, 0),
         (_prompt(14, 5), 5, 0)]
LATER = [(_prompt(16, 6), 4, 5),
         (np.concatenate([_prompt(16, 1), _prompt(16, 7)]), 6, 0)]


def _drive_trace(loop, request_cls):
    hs = [loop.submit(request_cls(prompt=p, max_new=m, priority=q))
          for p, m, q in FIRST]
    loop.schedule()
    hs += [loop.submit(request_cls(prompt=p, max_new=m, priority=q))
           for p, m, q in LATER]
    loop.schedule()
    loop._step_block()
    loop.run()
    return hs


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_priority_trace_equals_reference_serve_loop(kv):
    jm, jp, tm, tp = _pair(kv)
    kw = dict(lanes=2, eos=-1, block=4, chunk_prefill=C,
              prefix_cache_bytes=64 << 20)
    jloop = JaxServeLoop(jm, jp, window=None, **kw)
    tloop = ServeLoop(tm, tp, device="cpu", **kw)
    jh = _drive_trace(jloop, JaxRequest)
    th = _drive_trace(tloop, Request)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    for field in ("admit_seq", "preemptions", "prefix_tokens",
                  "group_size"):
        assert ([getattr(h.stats, field) for h in th]
                == [getattr(h.stats, field) for h in jh]), field
    for name in ("preemptions", "reservations", "reserved_admits",
                 "prefill_dispatches", "admit_dispatches",
                 "grouped_admissions", "chunk_dispatches",
                 "preempt_cache_inserts", "prefix_hits"):
        assert tloop.counters[name] == jloop.counters[name], name
    c = tloop.counters
    assert c["preemptions"] == 1 and th[0].stats.preemptions == 1
    assert c["reservations"] == c["reserved_admits"] > 0
    assert c["grouped_admissions"] == 1
    # the victim was preempted before its first decode step: its capture
    # is a rows donor only when cache_prefix_rows accepts it (bf16, not
    # the quantized cache), and the sibling prompt then resumes from it
    assert c["preempt_cache_inserts"] == (kv == "bf16")
    assert th[-1].stats.prefix_tokens == (C if kv == "bf16" else 0)


# ---------------------------------------------------------------------------
# the port alone: preemption, mixed knobs, generators, stop tokens
# ---------------------------------------------------------------------------


def _victim_run(kv, victim, preempt):
    """Victim + a sampled priority-1 filler on 2 lanes, one block, then
    (with `preempt`) a priority-5 arrival → (victim handle, loop). The
    filler keeps every lane's generator moving while the victim waits, so
    a resume that did not restore its carry would show."""
    model, params = _port(kv)
    loop = _loop(model, params, 2)
    h = loop.submit(Request(**victim))
    loop.submit(Request(prompt=_prompt(16, 90), max_new=16, priority=1,
                        sampling=TOP_P, sample_seed=5))
    loop.schedule()
    loop._step_block()
    if preempt:
        loop.submit(Request(prompt=_prompt(16, 91), max_new=4, priority=5))
    loop.run()
    return h, loop


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("sampling", [None, TOP_K], ids=["greedy",
                                                         "sampled"])
def test_preempted_victim_resumes_token_identical(kv, sampling):
    victim = dict(prompt=_prompt(16, 1), max_new=12, priority=0,
                  sampling=sampling, sample_seed=13 if sampling else None)
    h, loop = _victim_run(kv, victim, preempt=True)
    assert loop.counters["preemptions"] == h.stats.preemptions == 1
    h_alone, _ = _victim_run(kv, victim, preempt=False)
    assert h.tokens == h_alone.tokens and len(h.tokens) == 12


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mixed_knobs_reproduce_solo_streams(kv):
    """Two greedy requests (one grouped admission), a top-k and a top-p
    request with pinned seeds, on 3 lanes: each stream equals the
    request's solo run on a 3-lane loop (lane 0, the other lanes idle)."""
    model, params = _port(kv)
    reqs = [dict(prompt=_prompt(16, 1), max_new=8),
            dict(prompt=_prompt(12, 2), max_new=8),
            dict(prompt=_prompt(16, 3), max_new=8, sampling=TOP_K,
                 sample_seed=7),
            dict(prompt=_prompt(20, 4), max_new=6, sampling=TOP_P,
                 sample_seed=11)]
    loop = _loop(model, params, 3)
    hs = [loop.submit(Request(**kw)) for kw in reqs]
    loop.run()
    assert loop.counters["grouped_admissions"] == 1
    lanes = []
    for h, kw in zip(hs, reqs):
        solo = _loop(model, params, 3)
        hsolo = solo.submit(Request(**kw))
        solo.run()
        assert hsolo.stats.lane == 0
        assert h.tokens == hsolo.tokens, h.rid
        assert len(h.tokens) == kw["max_new"]
        lanes.append(h.stats.lane)
    assert lanes[2] != 0 and hs[0].stats.group_size == 2
    greedy = _loop(model, params, 3)
    hg = greedy.submit(Request(prompt=reqs[2]["prompt"], max_new=8))
    greedy.run()
    assert hg.tokens != hs[2].tokens           # the knobs reached the lane


def test_seeded_stream_is_a_function_of_its_seed():
    model, params = _port()

    def stream(seed, lanes):
        loop = _loop(model, params, lanes)
        h = loop.submit(Request(prompt=_prompt(16, 3), max_new=8,
                                sampling=TOP_K, sample_seed=seed))
        loop.run()
        return h.tokens

    assert stream(7, 2) == stream(7, 2)
    assert stream(7, 2) != stream(8, 2)


def test_all_greedy_loop_leaves_generators_untouched():
    """No lane samples: the block takes the argmax, admission seeds
    nothing, and neither the loop's stream nor any lane carry moves (also
    with a loop-level top_k, which greedy ignores)."""
    model, params = _port()

    def serve(**kw):
        loop = _loop(model, params, 2, **kw)
        hs = [loop.submit(Request(prompt=_prompt(16, s), max_new=8))
              for s in (1, 2, 3)]
        gen0 = loop._gen.get_state()
        lanes0 = [g.get_state() for g in loop._lane_gens]
        loop.run()
        assert torch.equal(loop._gen.get_state(), gen0)
        for g, s in zip(loop._lane_gens, lanes0):
            assert torch.equal(g.get_state(), s)
        return [h.tokens for h in hs]

    assert serve() == serve(top_k=5)


def test_loop_sampling_draws_seeds_from_the_loop_stream():
    """Loop-level sampling with no pinned seed: each admission draws a
    seed from the loop's stream, so `sample_seed` fixes every stream."""
    model, params = _port()

    def serve(seed):
        loop = _loop(model, params, 2, temperature=1.0, top_k=8,
                     sample_seed=seed)
        hs = [loop.submit(Request(prompt=_prompt(16, s), max_new=6))
              for s in (1, 2, 3)]
        gen0 = loop._gen.get_state()
        loop.run()
        assert not torch.equal(loop._gen.get_state(), gen0)
        return [h.tokens for h in hs]

    assert serve(3) == serve(3)
    assert serve(3) != serve(4)


def test_perlane_eos_via_sampling_params():
    """`SamplingParams(eos=...)` stops one lane on its own token while its
    neighbour (loop eos -1) runs its whole budget. The stop token is one
    whose first occurrence in the stream is at index >= 1, so the stream
    up to it is not empty."""
    model, params = _port()
    probe = _loop(model, params, 2)
    hp = probe.submit(Request(prompt=_prompt(16, 1), max_new=8))
    probe.run()
    toks = hp.tokens
    cut = next(i for i, t in enumerate(toks) if i >= 1 and toks.index(t) == i)
    loop = _loop(model, params, 2)
    h_stop = loop.submit(Request(prompt=_prompt(16, 1), max_new=8,
                                 sampling=SamplingParams(eos=toks[cut])))
    h_full = loop.submit(Request(prompt=_prompt(16, 2), max_new=8))
    loop.run()
    assert h_stop.tokens == toks[:cut]         # a stop, not an output
    assert len(h_full.tokens) == 8


def test_preemption_capture_is_a_copy():
    """The captured state is not a view of the live state: the next
    occupant of the victim's lane writes that lane, and the capture keeps
    its values."""
    model, params = _port()
    loop = _loop(model, params, 2)
    h = loop.submit(Request(prompt=_prompt(16, 1), max_new=12))
    loop.submit(Request(prompt=_prompt(16, 90), max_new=12, priority=1))
    loop.schedule()
    loop._step_block()
    loop.submit(Request(prompt=_prompt(16, 91), max_new=4, priority=5))
    loop.schedule()
    assert h.stats.preemptions == 1
    kv = loop._req_by_rid[h.rid].resume.state.kv
    before = kv.map(lambda a: a.clone())
    live = {loop.state.kv.k.data_ptr(), loop.state.kv.v.data_ptr()}
    assert kv.k.data_ptr() not in live and kv.v.data_ptr() not in live
    loop._step_block()                         # the new occupant decodes
    for name, a in vars(kv).items():
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, getattr(before, name)), name


def test_decoded_victim_never_feeds_the_prefix_cache():
    """A victim that has decoded (step past its prompt) is refused by
    `cache_prefix_rows`: no preemption insert."""
    model, params = _port()
    loop = _loop(model, params, 2, chunk_prefill=C,
                 prefix_cache_bytes=64 << 20)
    loop.submit(Request(prompt=_prompt(16, 1), max_new=12))
    loop.submit(Request(prompt=_prompt(16, 2), max_new=12, priority=1))
    loop.schedule()
    loop._step_block()
    loop.submit(Request(prompt=_prompt(16, 3), max_new=4, priority=5))
    loop.run()
    assert loop.counters["preemptions"] == 1
    assert loop.counters["preempt_cache_inserts"] == 0


def test_backdated_submit_takes_its_arrival_rank():
    model, params = _port()
    loop = _loop(model, params, 1)
    loop._t0 = 0.0                             # run clock started long ago
    for t in (0.0, 1.0, 2.0):
        loop.submit(Request(prompt=_prompt(16, 1), max_new=1, arrival=t))
    loop._drain_arrivals(1.5)
    late = loop.submit(Request(prompt=_prompt(16, 2), max_new=1,
                               arrival=0.5))
    assert [r.arrival for r in loop.queue] == [0.0, 0.5, 1.0, 2.0]
    assert loop.queue[1] is loop._req_by_rid[late.rid]


# ---------------------------------------------------------------------------
# mirrors of the reference's scheduler tests
# ---------------------------------------------------------------------------


def test_priority_admits_first():
    model, params = _port()
    loop = _loop(model, params, 1)
    h_lo = loop.submit(Request(prompt=_prompt(16, 1), max_new=4))
    h_hi = loop.submit(Request(prompt=_prompt(16, 2), max_new=4,
                               priority=3))
    loop.run()
    assert h_hi.stats.admit_seq < h_lo.stats.admit_seq
    assert loop.counters["preemptions"] == 0   # a free lane never preempts


def test_equal_priority_never_preempts():
    model, params = _port()
    loop = _loop(model, params, 2)
    for s in range(2):
        loop.submit(Request(prompt=_prompt(16, s), max_new=8, priority=2))
    loop.schedule()
    loop._step_block()
    loop.submit(Request(prompt=_prompt(16, 9), max_new=4, priority=2))
    loop.run()
    assert loop.counters["preemptions"] == 0
    assert len(loop.completed) == 3


def test_reservation_counts_and_is_bitwise_neutral():
    model, params = _port()

    def serve(reserve_blocks):
        loop = _loop(model, params, 2, reserve_blocks=reserve_blocks)
        hs = [loop.submit(Request(prompt=_prompt(16, s), max_new=8))
              for s in range(2)]
        loop.schedule()                        # saturate both lanes
        hs += [loop.submit(Request(prompt=_prompt(16, 10 + s), max_new=8))
               for s in range(3)]
        loop.run()
        return [h.tokens for h in hs], loop

    toks_res, loop_res = serve(reserve_blocks=8)
    toks_off, loop_off = serve(reserve_blocks=0)
    assert toks_res == toks_off
    assert loop_res.counters["reservations"] > 0
    assert (loop_res.counters["reserved_admits"]
            == loop_res.counters["reservations"])
    assert loop_off.counters["reservations"] == 0
    assert loop_off.counters["reserved_admits"] == 0


def test_predicted_free_blocks_uses_eos_stats():
    model, params = _port()
    loop = _loop(model, params, 1)
    loop.submit(Request(prompt=_prompt(16, 1), max_new=100))
    loop.schedule()
    assert loop.predicted_free_blocks() == {0: 25}   # 100 rem / block 4
    loop._eos_lens = [4, 4, 4, 4]
    assert loop.predicted_free_blocks() == {0: 1}    # bounded by the mean
    loop._budget_done = 5                      # budget exhaustion dominates
    assert loop.predicted_free_blocks() == {0: 25}


def test_predicted_free_blocks_class_local():
    model, params = _port()
    loop = _loop(model, params, 1)
    loop.submit(Request(prompt=_prompt(16, 1), max_new=100, priority=2))
    loop.schedule()
    st = loop.stats[loop._lane_rid[0]]
    loop._eos_lens = [40, 40, 40, 40]          # global mean 40 → 10 blocks
    loop._eos_by_class[(st.priority, st.bucket)] = [4, 4, 4]
    assert loop.predicted_free_blocks() == {0: 10}   # below the cell floor
    loop._eos_by_class[(st.priority, st.bucket)].append(4)
    assert loop.predicted_free_blocks() == {0: 1}    # class mean 4 → 1
    loop._eos_by_class[(0, st.bucket)] = [80, 80, 80, 80]
    assert loop.predicted_free_blocks() == {0: 1}


def test_eos_finishes_feed_the_drain_statistics():
    """A lane that stops on its stop token adds its length to the global
    and its class's EOS samples; one that spends its budget counts as a
    budget finish."""
    model, params = _port()
    probe = _loop(model, params, 1)
    hp = probe.submit(Request(prompt=_prompt(16, 1), max_new=6))
    probe.run()
    toks = hp.tokens
    cut = next(i for i, t in enumerate(toks) if i >= 1 and toks.index(t) == i)
    loop = _loop(model, params, 1)
    h = loop.submit(Request(prompt=_prompt(16, 1), max_new=6,
                            sampling=SamplingParams(eos=toks[cut])))
    loop.submit(Request(prompt=_prompt(16, 2), max_new=3))
    loop.run()
    assert loop._eos_lens == [cut] and loop._budget_done == 1
    assert loop._eos_by_class == {(0, h.stats.bucket): [cut]}
