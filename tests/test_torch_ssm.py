"""Mamba2's SSD block and the SSM family (mamba2-1.3b) in the port, against
the reference.

Reduced mamba2-1.3b (d 64, 2 layers, 8 heads of 16, state 16, chunk 32),
f32 on both sides, the reference's weights (`params.from_reference`) with
its constant leaves noised (`torch_parity.noisy_const_leaves`: `A_log`,
`dt_bias` and `conv_b` around 0, `D` and `norm_w` around 1), inputs from a
numpy seed:

- the pieces against `repro.models.ssm` and `repro.models.layers`, within
  1e-5 of the reference's largest magnitude + 1e-6: `_causal_conv` with and
  without a prior window, `ssd_chunked` at a T that is not a multiple of
  the chunk with and without an initial state (y and the final state),
  `ssm_train(return_state=True)` from an empty and a seeded state,
  `ssm_decode` (y and the new state), `rms_norm_gated`;
- `ssm_decode(active=...)` leaves an inactive lane's state bit for bit and
  gives the active lane the unmasked step;
- the model: prefill logits and the decode state within 2e-4, the
  teacher-forced decode logits within 2e-4 and the greedy tokens equal to
  the reference's; prefill→decode continuity (a decode of token t equals
  the prompt pass over t + 1 tokens, and the reference's full forward);
  `decode_step(active=...)` freezes an inactive lane's SSM state bit for
  bit; the family's flags (no cache, no bucketed or chunked prefill, a
  `length` refused);
- `ServeLoop` against the reference `ServeLoop(window=None)`: the
  downgrade of buckets and `chunk_prefill` to exact-length whole prompts,
  and a trace with a priority preemption (the victim resumes token-
  identical to its uninterrupted run) and an exact prefix-cache hit (the
  SSM state spliced back): tokens, admission order and counters equal.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import base as tbase  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from torch_parity import (decode_runs, drive_trace, model_pair,  # noqa: E402
                          noisy_const_leaves, to_np, trace_prompt)

jax.config.update("jax_platform_name", "cpu")

ARCH = "mamba2-1.3b"
JCFG = jbase.reduced(jbase.get_config(ARCH))
TCFG = tbase.reduced(tbase.get_config(ARCH))


def _close(got, want, what=""):
    """max|got - want| <= 1e-5 * max|want| + 1e-6."""
    got, want = to_np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max())
    lim = 1e-5 * float(np.abs(want).max()) + 1e-6
    assert err <= lim, (what, err, lim)


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _block():
    """One block's weights: the reference's init with its constant leaves
    noised, as numpy."""
    tree = jax.tree.map(np.asarray, jssm.init_ssm(jax.random.PRNGKey(0),
                                                  JCFG, jnp.float32))
    return noisy_const_leaves(tree, 1)


def _pair(tree):
    return (jax.tree.map(jnp.asarray, tree),
            from_reference(tree, "float32", "cpu"))


def _state(rng, b):
    d_in, h, conv_ch = jssm._dims(JCFG)
    s = JCFG.ssm
    return (_rand(rng, b, s.conv_kernel - 1, conv_ch),
            _rand(rng, b, h, s.head_dim, s.d_state, scale=0.5))


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prior", [False, True])
def test_causal_conv_matches_reference(prior):
    rng = np.random.default_rng(2)
    k, c = 4, 24
    x, w, b = _rand(rng, 2, 13, c), _rand(rng, k, c), _rand(rng, c)
    pr = _rand(rng, 2, k - 1, c) if prior else None
    want, want_prior = jssm._causal_conv(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
        None if pr is None else jnp.asarray(pr))
    got, got_prior = ssm._causal_conv(
        torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
        None if pr is None else torch.as_tensor(pr))
    _close(got, want, "out")
    _close(got_prior, want_prior, "window")


@pytest.mark.parametrize("seeded", [False, True])
def test_ssd_chunked_matches_reference(seeded):
    """T = 45 over chunks of 16: the last chunk holds 3 pads."""
    rng = np.random.default_rng(3)
    b, t, h, p, n, chunk = 2, 45, 4, 8, 16, 16
    xs, bm, cm = (_rand(rng, b, t, h, p), _rand(rng, b, t, h, n),
                  _rand(rng, b, t, h, n))
    dt = np.log1p(np.exp(_rand(rng, b, t, h))).astype(np.float32)
    a = -np.exp(_rand(rng, h, scale=0.5))
    init = _rand(rng, b, h, p, n) if seeded else None
    want_y, want_s = jssm.ssd_chunked(
        *(jnp.asarray(v) for v in (xs, dt, a, bm, cm)), chunk,
        None if init is None else jnp.asarray(init))
    got_y, got_s = ssm.ssd_chunked(
        *(torch.as_tensor(v) for v in (xs, dt, a, bm, cm)), chunk,
        None if init is None else torch.as_tensor(init))
    _close(got_y, want_y, "y")
    _close(got_s, want_s, "final state")


@pytest.mark.parametrize("seeded", [False, True])
def test_ssm_train_matches_reference(seeded):
    rng = np.random.default_rng(4)
    jp, tp = _pair(_block())
    x = _rand(rng, 2, 45, JCFG.d_model)
    jst = tst = None
    if seeded:
        conv, st = _state(rng, 2)
        jst = jssm.SSMState(jnp.asarray(conv), jnp.asarray(st))
        tst = ssm.SSMState(torch.as_tensor(conv), torch.as_tensor(st))
    want, wst = jssm.ssm_train(jp, jnp.asarray(x), JCFG, jst,
                               return_state=True)
    got, gst = ssm.ssm_train(tp, torch.as_tensor(x), TCFG, tst,
                             return_state=True)
    _close(got, want, "y")
    _close(gst.conv, wst.conv, "conv window")
    _close(gst.ssm, wst.ssm, "ssm state")


def test_ssm_decode_matches_reference():
    rng = np.random.default_rng(5)
    jp, tp = _pair(_block())
    x = _rand(rng, 3, JCFG.d_model)
    conv, st = _state(rng, 3)
    want, wst = jssm.ssm_decode(jp, jnp.asarray(x), JCFG,
                                jssm.SSMState(jnp.asarray(conv),
                                              jnp.asarray(st)))
    tst = ssm.SSMState(torch.as_tensor(conv), torch.as_tensor(st))
    got = ssm.ssm_decode(tp, torch.as_tensor(x), TCFG, tst)
    _close(got, want, "y")
    _close(tst.conv, wst.conv, "conv window")
    _close(tst.ssm, wst.ssm, "ssm state")


def test_ssm_decode_active_freezes_inactive_lanes():
    rng = np.random.default_rng(6)
    _, tp = _pair(_block())
    x = torch.as_tensor(_rand(rng, 3, TCFG.d_model))
    conv, st = (torch.as_tensor(a) for a in _state(rng, 3))
    full = ssm.SSMState(conv.clone(), st.clone())
    y_full = ssm.ssm_decode(tp, x, TCFG, full)
    masked = ssm.SSMState(conv.clone(), st.clone())
    active = torch.tensor([True, False, True])
    y = ssm.ssm_decode(tp, x, TCFG, masked, active)
    assert torch.equal(y, y_full)
    for got, old, new in ((masked.conv, conv, full.conv),
                          (masked.ssm, st, full.ssm)):
        assert torch.equal(got[1], old[1])              # frozen bit for bit
        assert torch.equal(got[active], new[active])
        assert not torch.equal(new[1], old[1])          # it would have moved


def test_rms_norm_gated_matches_reference():
    rng = np.random.default_rng(7)
    x, z = _rand(rng, 3, 5, 64, scale=2.0), _rand(rng, 3, 5, 64, scale=2.0)
    w = _rand(rng, 64) + 1.0
    want = jlayers.rms_norm_gated(jnp.asarray(x), jnp.asarray(z),
                                  jnp.asarray(w))
    got = L.rms_norm_gated(*(torch.as_tensor(a) for a in (x, z, w)))
    _close(got, want)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

DENSE = dict(max_seq=128)
TEACHER_STEPS, GREEDY_STEPS = 6, 10


@functools.lru_cache(maxsize=None)
def _models():
    return model_pair(ARCH, "dense", **DENSE)


def _tokens(vocab, b=2, n=40, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, n)).astype(
        np.int32)


@functools.lru_cache(maxsize=None)
def _runs():
    jm, jp, tm, tp = _models()
    teacher = _tokens(tm.cfg.vocab_size, TEACHER_STEPS, 2, seed=1)
    return decode_runs(jm, jp, tm, tp,
                       {"tokens": _tokens(tm.cfg.vocab_size)}, teacher,
                       GREEDY_STEPS)


def test_model_prefill_logits_and_state_match_reference():
    jm, jp, tm, tp = _models()
    toks = _tokens(tm.cfg.vocab_size)
    jlog, jst = jm.prefill(jp, {"tokens": jnp.asarray(toks)})
    tlog, tst = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    assert tst.kv is None and jst.kv is None
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=2e-4,
                               rtol=0)
    np.testing.assert_allclose(to_np(tst.ssm.conv), np.asarray(jst.ssm.conv),
                               atol=2e-4, rtol=0)
    np.testing.assert_allclose(to_np(tst.ssm.ssm), np.asarray(jst.ssm.ssm),
                               atol=2e-4, rtol=0)
    assert tst.ssm.conv.dtype == tst.ssm.ssm.dtype == torch.float32
    assert tst.ssm.ssm.shape == (tm.cfg.num_layers,) + jst.ssm.ssm.shape[1:]


def test_model_decode_logits_and_greedy_tokens_match_reference():
    (jl, tl), (jt, tt) = _runs()
    np.testing.assert_allclose(tl, jl, atol=2e-4, rtol=0)
    np.testing.assert_array_equal(tt, jt)


def test_prefill_decode_continuity():
    """prefill(t tokens) + decode(token t) equals prefill(t + 1 tokens) and
    the reference's full forward over t + 1 tokens."""
    jm, jp, tm, tp = _models()
    toks = _tokens(tm.cfg.vocab_size, 1, 33, seed=2)
    _, st = tm.prefill(tp, {"tokens": torch.as_tensor(toks[:, :32])})
    step, _ = tm.decode_step(tp, st, torch.as_tensor(toks[:, 32]))
    whole, _ = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    full, _ = jm.train_logits(jp, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(to_np(step), to_np(whole), atol=1e-4, rtol=0)
    np.testing.assert_allclose(to_np(step), np.asarray(full[:, -1]),
                               atol=2e-4, rtol=0)


def test_decode_step_active_freezes_a_lane_state():
    _, _, tm, tp = _models()
    toks = _tokens(tm.cfg.vocab_size, 3, 20, seed=3)
    _, st = tm.prefill(tp, {"tokens": torch.as_tensor(toks)})
    before = st.clone()
    free = st.clone()
    tok = torch.as_tensor(toks[:, -1])
    lf, free = tm.decode_step(tp, free, tok)
    active = torch.tensor([True, False, True])
    lm, st = tm.decode_step(tp, st, tok, active)
    torch.testing.assert_close(lm, lf, rtol=0, atol=0)
    for got, old, new in ((st.ssm.conv, before.ssm.conv, free.ssm.conv),
                          (st.ssm.ssm, before.ssm.ssm, free.ssm.ssm)):
        assert torch.equal(got[:, 1], old[:, 1])
        assert torch.equal(got[:, active], new[:, active])
        assert not torch.equal(new[:, 1], old[:, 1])


def test_ssm_family_flags_match_reference():
    jm, _, tm, tp = _models()
    assert tm.attn_layer_count() == jm.attn_layer_count() == 0
    assert tm.init_decode_state(2).kv is None
    for name in ("supports_bucketed_prefill", "supports_chunked_prefill"):
        assert getattr(tm, name)() is getattr(jm, name)() is False
    toks = torch.as_tensor(_tokens(tm.cfg.vocab_size, 2, 16))
    with pytest.raises(ValueError, match="recurrent state"):
        tm.prefill(tp, {"tokens": toks, "length": torch.tensor([16, 9])})


# ---------------------------------------------------------------------------
# ServeLoop
# ---------------------------------------------------------------------------


def test_serve_loop_downgrades_to_exact_length_whole_prompts():
    """Default buckets and chunk_prefill = 8 both downgrade, on both sides,
    and the stream is the reference's."""
    jm, jp, tm, tp = _models()
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
    assert th.stats.occupancy == 0.0


def test_serve_trace_with_preemption_and_exact_hit_equals_reference():
    jm, jp, tm, tp = _models()
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
             "decode_blocks")
    assert ({n: tloop.counters[n] for n in names}
            == {n: jloop.counters[n] for n in names})
    assert tloop.counters["preemptions"] == 1
    assert tloop.counters["prefix_exact_hits"] == 1
    # the victim resumes token-identical to its uninterrupted run
    alone, _ = drive_trace(tm, tp, Request, ServeLoop, tm.cfg.vocab_size,
                           later=False, device="cpu")
    victims = [i for i, h in enumerate(th) if h.stats.preemptions]
    assert victims and all(th[i].tokens == alone[i].tokens for i in victims)
