"""The hybrid family (zamba2-7b) in the port, against the reference.

Reduced zamba2-7b at 5 layers on both sides (d 64, SSD blocks of 8 heads,
a shared attention block of 4 heads over 2 kv-heads of 16 applied before
every 2 SSD blocks: 2 groups and a tail of 1, so `ssm_tail` exists and
the cache has 2 layers), f32, the reference's weights with the constant
leaves noised (`torch_parity.noisy_const_leaves`), inputs from a numpy
seed:

- the tree: `ssm_groups` stacked [2, 2, ...], `ssm_tail` [1, ...], one
  unstacked `shared_attn`; `attn_layer_count()` 2, as the reference's;
- prefill logits and the decode state (the SSM state and every KV-cache
  field) within 2e-4, under unicaim with bf16 and int8 KV;
- greedy tokens equal to the reference's and teacher-forced decode logits
  within 2e-4 under unicaim: bf16 and int8 KV, global selection and
  select_blocks 2 through the fused path (the decode kernels' plain
  versions on the CPU), and the composed path; under the dense policy
  too, with prefill→decode continuity (a decode of token t equals the
  prompt pass over t + 1 tokens);
- `decode_step(active=...)` freezes an inactive lane's SSM state and
  cache rows bit for bit;
- `ServeLoop` against the reference `ServeLoop(window=None)`, bf16 and int8
  KV: the downgrade to exact-length whole prompts, and a trace with a
  priority preemption and an exact prefix-cache hit (the SSM state and the
  pruned caches spliced back): tokens, admission order and counters
  equal; the preempted victim resumes token-identical.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro_torch.core.cache import FIELDS  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from torch_parity import (decode_runs, drive_trace, model_pair,  # noqa: E402
                          to_np, trace_prompt)

jax.config.update("jax_platform_name", "cpu")

ARCH = "zamba2-7b"
CUT = dict(num_layers=5)
UNICAIM = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2,
               recent_window=8)
TEACHER_STEPS, GREEDY_STEPS = 6, 10


@functools.lru_cache(maxsize=None)
def _models(kv="bf16", blocks=1, fused=True, policy="unicaim"):
    kw = (dict(max_seq=128) if policy == "dense" else
          dict(kv_dtype=kv, select_blocks=blocks, fused=fused, **UNICAIM))
    return model_pair(ARCH, policy, cfg_kw=CUT, **kw)


def _tokens(vocab, b=2, n=40, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


def test_tree_and_attention_layers_match_reference():
    jm, jp, tm, tp = _models()
    cfg = tm.cfg
    assert (cfg.num_layers, cfg.attn_period) == (5, 2)
    assert set(tp) == set(jp) >= {"ssm_groups", "ssm_tail", "shared_attn"}
    assert tp["ssm_groups"]["ssm"]["in_proj"].shape[:2] == (2, 2)
    assert tp["ssm_tail"]["ssm"]["A_log"].shape[0] == 1
    assert tp["shared_attn"]["attn"]["wq"].dim() == 2       # unstacked
    assert tm.attn_layer_count() == jm.attn_layer_count() == 2
    own = tm.init(0)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, dict(jp)))
    st = tm.init_decode_state(3)
    assert st.kv.k.shape[0] == 2 and st.ssm.ssm.shape[0] == 5
    assert not tm.supports_bucketed_prefill()
    assert not tm.supports_chunked_prefill()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_prefill_logits_and_state_match_reference(kv):
    jm, jp, tm, tp = _models(kv)
    toks = _tokens(tm.cfg.vocab_size)
    jlog, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, tst = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=2e-4,
                               rtol=0)
    for got, want in ((tst.ssm.conv, jst.ssm.conv), (tst.ssm.ssm,
                                                     jst.ssm.ssm)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=2e-4,
                                   rtol=0)
    for f in FIELDS:
        got, want = getattr(tst.kv, f), getattr(jst.kv, f)
        assert (got is None) == (want is None), f
        if got is None:
            continue
        got, want = to_np(got), np.asarray(want)
        if got.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, atol=2e-4, rtol=0,
                                       err_msg=f)


@functools.lru_cache(maxsize=None)
def _runs(kv, blocks, fused, policy="unicaim"):
    jm, jp, tm, tp = _models(kv, blocks, fused, policy)
    teacher = _tokens(tm.cfg.vocab_size, TEACHER_STEPS, 2, seed=1)
    return decode_runs(jm, jp, tm, tp,
                       {"tokens": _tokens(tm.cfg.vocab_size)}, teacher,
                       GREEDY_STEPS)


@pytest.mark.parametrize("kv,blocks,fused", [
    ("bf16", 1, True), ("int8", 1, True), ("bf16", 2, True),
    ("int8", 2, True), ("bf16", 1, False)])
def test_greedy_tokens_and_decode_logits_match_reference(kv, blocks, fused):
    (jl, tl), (jt, tt) = _runs(kv, blocks, fused)
    np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(tt, jt)


def test_dense_policy_tokens_and_continuity():
    (jl, tl), (jt, tt) = _runs("bf16", 1, True, "dense")
    np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(tt, jt)
    _, _, tm, tp = _models(policy="dense")
    toks = _tokens(tm.cfg.vocab_size, 1, 33, seed=2)
    _, st = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :32])})
    step, _ = tm.decode_step(tp, st, torch.as_tensor(toks[:, 32]))
    whole, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    np.testing.assert_allclose(to_np(step), to_np(whole), atol=1e-4, rtol=0)


def test_decode_step_active_freezes_a_lane():
    _, _, tm, tp = _models()
    toks = _tokens(tm.cfg.vocab_size, 3, 30, seed=3)
    _, st = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    before = st.clone()
    free = st.clone()
    tok = torch.as_tensor(toks[:, -1])
    _, free = tm.decode_step(tp, free, tok)
    active = torch.tensor([True, False, True])
    _, st = tm.decode_step(tp, st, tok, active)
    pairs = [(st.ssm.conv, before.ssm.conv, free.ssm.conv),
             (st.ssm.ssm, before.ssm.ssm, free.ssm.ssm)]
    pairs += [(getattr(st.kv, f), getattr(before.kv, f), getattr(free.kv, f))
              for f in FIELDS if getattr(st.kv, f) is not None]
    for got, old, new in pairs:
        assert torch.equal(got[:, 1], old[:, 1])
        assert torch.equal(got[:, active], new[:, active])
    assert not torch.equal(free.ssm.ssm[:, 1], before.ssm.ssm[:, 1])
    assert not torch.equal(free.kv.step[:, 1], before.kv.step[:, 1])


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_loop_downgrades_to_exact_length_whole_prompts(kv):
    jm, jp, tm, tp = _models(kv)
    prompt = trace_prompt(tm.cfg.vocab_size, 24, 1)
    jloop = JaxServeLoop(jm, jp, lanes=2, eos=-1, block=2, chunk_prefill=8,
                         window=None)
    tloop = ServeLoop(tm, tp, lanes=2, eos=-1, block=2, chunk_prefill=8,
                      device="cpu")
    assert tloop.buckets is None and tloop.chunk_prefill == 0
    assert jloop.buckets is None and jloop.chunk_prefill == 0
    jh = jloop.submit(JaxRequest(prompt=prompt, max_new=3))
    th = tloop.submit(Request(prompt=prompt, max_new=3))
    jloop.run()
    tloop.run()
    assert len(th.tokens) == 3 and th.tokens == jh.tokens
    assert th.stats.occupancy == pytest.approx(jh.stats.occupancy)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_trace_with_preemption_and_exact_hit_equals_reference(kv):
    jm, jp, tm, tp = _models(kv)
    (jh, jloop), (th, tloop) = (
        drive_trace(m, p, cls, loop_cls, tm.cfg.vocab_size, **kw)
        for m, p, cls, loop_cls, kw in (
            (jm, jp, JaxRequest, JaxServeLoop, {"window": None}),
            (tm, tp, Request, ServeLoop, {"device": "cpu"})))
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    for field in ("lane", "admit_seq", "preemptions", "prefix_exact",
                  "group_size"):
        assert ([getattr(h.stats, field) for h in th]
                == [getattr(h.stats, field) for h in jh]), field
    names = ("preemptions", "prefill_dispatches", "admit_dispatches",
             "grouped_admissions", "prefix_lookups", "prefix_hits",
             "prefix_exact_hits", "prefix_copies", "prefix_tokens_reused",
             "prefix_inserts", "reservations", "reserved_admits",
             "decode_blocks", "preempt_cache_inserts")
    assert ({n: tloop.counters[n] for n in names}
            == {n: jloop.counters[n] for n in names})
    assert tloop.counters["preemptions"] == 1
    assert tloop.counters["prefix_exact_hits"] == 1
    alone, _ = drive_trace(tm, tp, Request, ServeLoop, tm.cfg.vocab_size,
                           later=False, device="cpu")
    victims = [i for i, h in enumerate(th) if h.stats.preemptions]
    assert victims and all(th[i].tokens == alone[i].tokens for i in victims)
