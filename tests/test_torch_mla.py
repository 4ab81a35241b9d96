"""MLA latent attention and the mla_moe family (deepseek-v3-671b) in the
port, against the reference, on reduced deepseek-v3 (latent 40, 4 heads,
2 layers: one mla_dense and one mla_moe block, 4 experts), f32, the
reference's weights through `params.from_reference` with the MLA norms
and the zero-initialised leaves noised (`torch_parity.noisy_const_leaves`),
inputs from a numpy seed:

- `_queries`, `_latents` and `_mla_attend` (out and the column sums, with
  bucketed lengths and an observation window) against `repro.models.mla`,
  1e-5;
- `mla_prefill`: the kept positions exactly, the latents within 1e-5, the
  int8 codes (the mirror in bf16 mode, the stored latent in int8 mode)
  exactly;
- the model, prompts of 9 and 26 tokens: the reference's greedy tokens for
  8 steps, each step's logits within 1e-4, under unicaim (top-k,
  threshold, select_blocks = 2, accumulate = "exact"; bf16 and int8 KV),
  h2o, streaming and dense;
- the reference's quirks, in both packages: without a mesh its
  `_latent_attend` takes the global top-k whatever `select_mode` and
  `select_blocks` say and accumulates the approximate probabilities under
  `accumulate="exact"`, so those knobs give the top-k run's logits bit for
  bit;
- an `active` mask freezes a lane's latent rows, fill, step and acc, as
  the reference's `decode_block_masked` does;
- the init tree (keys, shapes and dtypes, the `mtp` head included) is the
  reference's `Model.init` tree;
- `ServeLoop` traces (2 lanes, 5 requests, grouped bucketed admission; and
  with `chunk_prefill` set, which an MLA model ignores: whole prompts)
  give the reference `ServeLoop`'s streams, admission order and counters;
- the CAM scores' f32 product of ±127 codes stays exact at the latent's
  d = 576, up to `scoring.EXACT_MAX_D`, and raises above it.
"""
import dataclasses
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.configs import base as jbase  # noqa: E402
from repro.core import baselines as jax_baselines  # noqa: E402
from repro.core import cache as jcache  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro.launch.serve import (_decode_step_fn, _model_key,  # noqa: E402
                                _prefill_fn, decode_block_masked)
from repro.models import mla as jmla  # noqa: E402
from repro.models.transformer import Model as JaxModel  # noqa: E402
from repro_torch.core import baselines, cache as tcache  # noqa: E402
from repro_torch.core import scoring  # noqa: E402
from repro_torch.core.cache import FIELDS  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.models import mla  # noqa: E402
from repro_torch.models.transformer import Model  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from torch_parity import noisy_const_leaves, port_cfg, to_np  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "deepseek-v3-671b"
UNICAIM = dict(heavy=16, reserve=4, select_k=8, sink_tokens=2,
               recent_window=4)
LENGTHS, WIDTH, STEPS = (9, 26), 26, 8


@functools.lru_cache(maxsize=None)
def _weights():
    """(reference config, port config, the noised numpy tree): one init for
    the whole file. The norms' `w` stay at one: with them noised too, the
    one-ulp perturbation meets a near-tie under the dense policy (15 of 16
    steps agree) and leaves the int8 race's winners in place, in both
    packages alike."""
    jcfg = jbase.reduced(jbase.get_config(ARCH))
    tree = jax.tree.map(np.asarray, JaxModel(
        jcfg, jax_baselines.unicaim(**UNICAIM)).init(jax.random.PRNGKey(0)))
    return jcfg, port_cfg(jcfg), noisy_const_leaves(tree, 0, norm_w=False)


@pytest.fixture(scope="module")
def weights():
    jcfg, tcfg, tree = _weights()
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, tree),
            from_reference(tree, "float32", "cpu"))


def _attn(params, seg="seg0_mla_dense"):
    """Layer 0's MLA weights of `seg` (the stacked axis dropped)."""
    return {k: v[0] for k, v in params[seg]["attn"].items()}


def _x(cfg, b=2, t=WIDTH, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _prompts(vocab):
    rng = np.random.default_rng(0)
    tokens = np.zeros((2, WIDTH), np.int32)
    for i, n in enumerate(LENGTHS):
        tokens[i, :n] = rng.integers(0, vocab, n)
    return tokens, np.asarray(LENGTHS, np.int32)


# ---------------------------------------------------------------------------
# the module's pieces
# ---------------------------------------------------------------------------


def test_queries_and_latents_match_reference(weights):
    jcfg, tcfg, jp, tp = weights
    x = _x(tcfg)
    pos = np.arange(WIDTH)[None] + 5
    jpa, tpa = _attn(jp), _attn(tp)
    jn, jr = jmla._queries(jpa, jnp.asarray(x), jcfg, jnp.asarray(pos))
    tn, tr = mla._queries(tpa, torch.as_tensor(x), tcfg, torch.as_tensor(pos))
    ju = jmla._latents(jpa, jnp.asarray(x), jcfg, jnp.asarray(pos))
    tu = mla._latents(tpa, torch.as_tensor(x), tcfg, torch.as_tensor(pos))
    assert tu.shape == (2, WIDTH, tcfg.mla.latent_dim) == (2, WIDTH, 40)
    for got, want in ((tn, jn), (tr, jr), (tu, ju)):
        np.testing.assert_allclose(to_np(got), np.asarray(want), atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("length,obs", [(None, 0), ((26, 11), 0),
                                        ((26, 17), 8)])
def test_mla_attend_matches_reference(weights, length, obs):
    jcfg, tcfg, jp, tp = weights
    x = _x(tcfg, seed=4)
    pos = np.arange(WIDTH)[None]
    ln = None if length is None else np.asarray(length, np.int32)
    jo, ju, ja = jmla._mla_attend(
        _attn(jp, "seg1_mla_moe"), jnp.asarray(x), jcfg, jnp.asarray(pos),
        16, obs_window=obs, length=None if ln is None else jnp.asarray(ln))
    to, tu, ta = mla._mla_attend(
        _attn(tp, "seg1_mla_moe"), torch.as_tensor(x), tcfg,
        torch.as_tensor(pos), 16, obs_window=obs,
        length=None if ln is None else torch.as_tensor(ln))
    assert ta.shape == (2, 1, WIDTH)
    live = np.ones((2, WIDTH), bool) if ln is None else (
        np.arange(WIDTH)[None] < ln[:, None])
    np.testing.assert_allclose(to_np(to)[live], np.asarray(jo)[live],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_np(tu), np.asarray(ju), atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_np(ta), np.asarray(ja), atol=1e-5, rtol=0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_mla_prefill_matches_reference(weights, kv):
    jcfg, tcfg, jp, tp = weights
    x = _x(tcfg, seed=5)
    pos = np.arange(WIDTH)[None]
    ln = np.asarray((26, 20), np.int32)
    kw = dict(UNICAIM, kv_dtype=kv)
    jprune, tprune = jax_baselines.unicaim(**kw), baselines.unicaim(**kw)
    lat = tcfg.mla.latent_dim
    jc = jcache.init_cache(2, 1, lat, jprune.slots, jprune, jnp.float32,
                           latent=True)
    tc = tcache.init_cache(2, 1, lat, tprune.slots, tprune, torch.float32,
                           latent=True)
    assert tc.v is None and tc.vscale is None
    assert (tc.kq is None) == (kv == "int8")
    _, jc = jmla.mla_prefill(_attn(jp), jnp.asarray(x), jcfg,
                             jnp.asarray(pos), jprune, jc,
                             length=jnp.asarray(ln))
    _, tc = mla.mla_prefill(_attn(tp), torch.as_tensor(x), tcfg,
                            torch.as_tensor(pos), tprune, tc,
                            length=torch.as_tensor(ln))
    for f in ("pos", "valid", "fill", "step"):
        np.testing.assert_array_equal(to_np(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)), f)
    codes = ("k",) if kv == "int8" else ("kq",)
    for f in codes:
        np.testing.assert_array_equal(to_np(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)), f)
    floats = ("kscale", "acc") if kv == "int8" else ("k", "kscale", "acc")
    for f in floats:
        np.testing.assert_allclose(to_np(getattr(tc, f)),
                                   np.asarray(getattr(jc, f)), atol=1e-5,
                                   rtol=1e-6, err_msg=f)
    assert not tcache.prefix_slot_aligned(tc, int(ln[1]))


# ---------------------------------------------------------------------------
# the model: logits and greedy tokens, every policy
# ---------------------------------------------------------------------------

# (policy, knobs): the unicaim variants beside top-k are the quirks
VARIANTS = {
    "topk": ("unicaim", {}),
    "threshold": ("unicaim", {"select_mode": "threshold"}),
    "blocks2": ("unicaim", {"select_blocks": 2}),
    "exact": ("unicaim", {"accumulate": "exact"}),
    "h2o": ("h2o", {}),
    "streaming": ("streaming", {}),
    "dense": ("dense", {}),
}
QUIRKS = ("threshold", "blocks2", "exact")


def _prune_kw(variant, kv):
    policy, knobs = VARIANTS[variant]
    if policy == "unicaim":
        return policy, dict(UNICAIM, kv_dtype=kv, **knobs)
    if policy == "h2o":
        return policy, dict(heavy=UNICAIM["heavy"], reserve=UNICAIM["reserve"])
    if policy == "streaming":
        return policy, dict(budget=UNICAIM["heavy"] + UNICAIM["reserve"])
    return policy, dict(max_seq=WIDTH + STEPS + 2)


def _models(variant, kv):
    policy, kw = _prune_kw(variant, kv)
    jcfg, tcfg, _ = _weights()
    return (JaxModel(jcfg, getattr(jax_baselines, policy)(**kw)),
            Model(tcfg, getattr(baselines, policy)(**kw), device="cpu"))


@functools.lru_cache(maxsize=None)
def _greedy(variant, kv):
    """Prefill and STEPS greedy steps on both sides, each fed the
    reference's tokens → (reference logits, port logits [1 + STEPS, B, V],
    reference tokens, port argmax tokens [STEPS, B])."""
    jm, tm = _models(variant, kv)
    _, _, tree = _weights()
    jp, tp = jax.tree.map(jnp.asarray, tree), from_reference(tree)
    tokens, length = _prompts(tm.cfg.vocab_size)
    jlog, jst = _prefill_fn(_model_key(jm))(
        jp, {"tokens": jnp.asarray(tokens), "length": jnp.asarray(length)})
    tlog, tst = tm.prefill(tp, {"tokens": torch.as_tensor(tokens),
                                "length": torch.as_tensor(length)})
    step = _decode_step_fn(_model_key(jm))
    jl, tl, jt, tt = [np.asarray(jlog)], [to_np(tlog)], [], []
    for _ in range(STEPS):
        tok = np.asarray(jnp.argmax(jl[-1], -1)).astype(np.int32)
        jt.append(tok)
        tt.append(to_np(torch.argmax(torch.as_tensor(tl[-1]), -1)))
        lj, jst = step(jp, jst, jnp.asarray(tok))
        lt, tst = tm.decode_step(tp, tst, torch.as_tensor(tok))
        jl.append(np.asarray(lj))
        tl.append(to_np(lt))
    return np.stack(jl), np.stack(tl), np.stack(jt), np.stack(tt)


GREEDY_CASES = [(v, kv) for v in VARIANTS for kv in ("bf16", "int8")
                if kv == "bf16" or VARIANTS[v][0] == "unicaim"]


@pytest.mark.parametrize("variant,kv", GREEDY_CASES)
def test_model_greedy_tokens_and_logits_match_reference(variant, kv):
    jl, tl, jt, tt = _greedy(variant, kv)
    np.testing.assert_allclose(tl, jl, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(tt, jt)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_latent_attend_ignores_select_mode_blocks_and_accumulate(kv):
    """The reference's quirks, kept by the port: the threshold race,
    select_blocks = 2 and exact accumulation give the top-k run's logits
    bit for bit in each package."""
    jl, tl, _, _ = _greedy("topk", kv)
    for variant in QUIRKS:
        jq, tq, _, _ = _greedy(variant, kv)
        np.testing.assert_array_equal(jq, jl, err_msg=variant)
        np.testing.assert_array_equal(tq, tl, err_msg=variant)


def _latent_ulp_signs(shape):
    """±1 from a numpy seed: the direction each latent value moves."""
    return np.where(np.random.default_rng(22).random(shape) < 0.5, -1.0,
                    1.0).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _perturbed(variant, kv):
    """The prompt pass with every latent row moved by one bf16 ulp of each
    value (2^(e - 8) for u = m 2^e, m in [0.5, 1); signs from
    `_latent_ulp_signs`), through `_latents` in each package, then STEPS
    steps fed the reference's clean greedy tokens (`_greedy`) → (reference
    logits, port logits [1 + STEPS, B, V])."""
    jm, tm = _models(variant, kv)
    _, _, tree = _weights()
    jp, tp = jax.tree.map(jnp.asarray, tree), from_reference(tree)
    tokens, length = _prompts(tm.cfg.vocab_size)
    _, _, teacher, _ = _greedy(variant, kv)
    j_lat, t_lat = jmla._latents, mla._latents

    def j_moved(*a, **kw):
        u = j_lat(*a, **kw)
        _, e = jnp.frexp(u)
        return u + jnp.asarray(_latent_ulp_signs(u.shape)) * jnp.ldexp(
            jnp.ones_like(u), e - 8)

    def t_moved(*a, **kw):
        u = t_lat(*a, **kw)
        _, e = torch.frexp(u)
        return u + torch.as_tensor(_latent_ulp_signs(tuple(u.shape))) * \
            torch.ldexp(torch.ones_like(u), e - 8)

    jmla._latents, mla._latents = j_moved, t_moved
    try:                                 # a fresh trace sees the patch
        jlog, jst = jax.jit(jm.prefill)(
            jp, {"tokens": jnp.asarray(tokens),
                 "length": jnp.asarray(length)})
        tlog, tst = tm.prefill(tp, {"tokens": torch.as_tensor(tokens),
                                    "length": torch.as_tensor(length)})
    finally:
        jmla._latents, mla._latents = j_lat, t_lat
    step = _decode_step_fn(_model_key(jm))
    jl, tl = [np.asarray(jlog)], [to_np(tlog)]
    for tok in teacher:
        lj, jst = step(jp, jst, jnp.asarray(tok))
        lt, tst = tm.decode_step(tp, tst, torch.as_tensor(tok))
        jl.append(np.asarray(lj))
        tl.append(to_np(lt))
    return np.stack(jl), np.stack(tl)


@pytest.mark.parametrize("variant,kv", [("topk", "bf16"), ("topk", "int8"),
                                        ("dense", "bf16")])
def test_one_ulp_latent_perturbation_moves_both_packages_alike(variant, kv):
    """Whether MLA under unicaim is as sensitive in the reference as in
    the port: one prompt pass's latent rows moved by one bf16 ulp, then
    the clean run's tokens fed to both states. Teacher-forced top-1 of the
    perturbed run against the clean one agrees equally often in both
    packages: under unicaim the 4-bit CAM race turns the moved latents
    into other winners and other tokens in the reference as in the port,
    under the dense policy every step agrees. So the card's 45 / 42 of 64
    under unicaim measure the race's sensitivity, not the kernel's."""
    jl, tl, _, _ = _greedy(variant, kv)
    jp_, tp_ = _perturbed(variant, kv)
    agree_j = int((jl[1:].argmax(-1) == jp_[1:].argmax(-1)).sum())
    agree_t = int((tl[1:].argmax(-1) == tp_[1:].argmax(-1)).sum())
    assert agree_t == agree_j
    total = STEPS * len(LENGTHS)
    if VARIANTS[variant][0] == "dense":
        assert agree_j == total
        assert np.abs(jp_ - jl).max() < 0.5
    else:
        assert agree_j < total
        assert np.abs(jp_ - jl).max() > 1.0
    if kv == "bf16":                     # the perturbed runs: one function
        np.testing.assert_allclose(tp_, jp_, atol=1e-4, rtol=0)


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_active_mask_freezes_a_lane_like_decode_block_masked(weights, kv):
    """Three steps with lane 1 inactive: lane 1's cache is the prefilled
    one in both packages, lane 0's the reference's."""
    _, _, jp, tp = weights
    jm, tm = _models("topk", kv)
    tokens, length = _prompts(tm.cfg.vocab_size)
    jlog, jst0 = _prefill_fn(_model_key(jm))(
        jp, {"tokens": jnp.asarray(tokens), "length": jnp.asarray(length)})
    _, tst = tm.prefill(tp, {"tokens": torch.as_tensor(tokens),
                             "length": torch.as_tensor(length)})
    before = tst.kv.clone()
    active = np.array([True, False])
    jst, _, _, _, _, toks, _ = decode_block_masked(
        jm, jp, jst0, jnp.argmax(jlog, -1).astype(jnp.int32),
        jnp.asarray(active), jnp.asarray([3, 3], jnp.int32), -1,
        jax.random.PRNGKey(0), 3)
    for tok in np.asarray(toks):
        tm.decode_step(tp, tst, torch.as_tensor(tok),
                       active=torch.as_tensor(active))
    for f in FIELDS:
        got, old = getattr(tst.kv, f), getattr(before, f)
        if got is None:
            assert getattr(jst.kv, f) is None, f
            continue
        want = np.asarray(getattr(jst.kv, f))
        assert torch.equal(got[:, 1], old[:, 1]), f
        np.testing.assert_array_equal(want[:, 1], np.asarray(
            getattr(jst0.kv, f))[:, 1], f)
        np.testing.assert_allclose(to_np(got[:, 0]).astype(np.float64),
                                   want[:, 0].astype(np.float64), atol=1e-5,
                                   rtol=0, err_msg=f)
    assert int(tst.kv.step[0, 0]) == LENGTHS[0] + 3


# ---------------------------------------------------------------------------
# the tree
# ---------------------------------------------------------------------------


def _tree_spec(tree):
    if isinstance(tree, dict):
        return {k: _tree_spec(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_spec(v) for v in tree]
    return (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))


def test_init_tree_is_the_reference_tree():
    """bf16 weights: the segments seg0_mla_dense and seg1_mla_moe, the MLA
    keys, the dense blocks at d_ff_dense, the f32 router and the mtp head
    (proj, norm, one unstacked mla_dense block), from `Model.init` and
    through `from_reference`."""
    jcfg = jbase.reduced(jbase.get_config(ARCH), param_dtype="bfloat16")
    jtree = jax.tree.map(np.asarray, JaxModel(
        jcfg, jax_baselines.unicaim(**UNICAIM)).init(jax.random.PRNGKey(1)))
    want = _tree_spec(jtree)
    assert {"seg0_mla_dense", "seg1_mla_moe", "mtp"} <= set(want)
    assert set(want["seg0_mla_dense"]["attn"]) == {
        "wq_a", "q_norm", "wq_b", "wkv_a", "kv_norm", "wkv_b", "wo"}
    model = Model(port_cfg(jcfg), baselines.unicaim(**UNICAIM), device="cpu")
    assert _tree_spec(model.init(0)) == want
    assert _tree_spec(from_reference(jtree, "bfloat16")) == want


# ---------------------------------------------------------------------------
# ServeLoop
# ---------------------------------------------------------------------------

SERVE_LENS = [9, 12, 14, 20, 33]
SERVE_BUDGETS = [6, 10, 4, 9, 5]
COUNTERS = ("prefill_dispatches", "chunk_dispatches", "admit_dispatches",
            "grouped_admissions", "grouped_requests", "decode_blocks",
            "reservations", "reserved_admits")


@pytest.mark.parametrize("kv,chunk", [("bf16", 0), ("int8", 16)])
def test_serve_loop_streams_equal_reference(weights, kv, chunk):
    """Grouped bucketed admission on 2 lanes; chunk_prefill, which an MLA
    model turns down on both sides (whole prompts, no chunk
    dispatches)."""
    _, _, jp, tp = weights
    jm, tm = _models("topk", kv)
    rng = np.random.default_rng(4)
    trace = [(rng.integers(0, tm.cfg.vocab_size, n), m)
             for n, m in zip(SERVE_LENS, SERVE_BUDGETS)]
    jloop = JaxServeLoop(jm, jp, lanes=2, block=4, chunk_prefill=chunk,
                         window=None)
    tloop = ServeLoop(tm, tp, lanes=2, block=4, chunk_prefill=chunk,
                      device="cpu")
    assert tloop.chunk_prefill == 0
    jh = [jloop.submit(JaxRequest(prompt=p, max_new=m)) for p, m in trace]
    th = [tloop.submit(Request(prompt=p, max_new=m)) for p, m in trace]
    jloop.run()
    tloop.run()
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    for field in ("lane", "admit_seq", "bucket"):
        assert ([getattr(h.stats, field) for h in th]
                == [getattr(h.stats, field) for h in jh]), field
    assert ({c: tloop.counters[c] for c in COUNTERS}
            == {c: jloop.counters[c] for c in COUNTERS})
    assert tloop.counters["grouped_requests"] >= 2
    assert tloop.counters["chunk_dispatches"] == 0


# ---------------------------------------------------------------------------
# the CAM scores' exactness at the latent width
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [576, scoring.EXACT_MAX_D])
def test_approx_scores_stay_exact_at_latent_width(d):
    """±127 codes (the worst case: every product 127², one sign) and
    seeded ones give the int64 product exactly at d = 576 and at the
    limit."""
    rng = np.random.default_rng(d)
    qq = rng.integers(-127, 128, (2, 4, d)).astype(np.int8)
    kq = rng.integers(-127, 128, (2, 1, 8, d)).astype(np.int8)
    qq[0, 0], kq[0, 0, 0] = 127, 127                      # all one sign
    qq[1, 1], kq[1, 0, 3] = -127, 127
    ones = torch.ones((2, 4)), torch.ones((2, 1, 8))
    got = scoring.approx_scores(torch.as_tensor(qq), ones[0],
                                torch.as_tensor(kq), ones[1],
                                torch.ones((2, 1, 8), dtype=torch.bool))
    want = np.einsum("bhd,bsd->bhs", qq.astype(np.int64),
                     kq[:, 0].astype(np.int64))
    assert abs(want).max() == d * 127 ** 2
    np.testing.assert_array_equal(to_np(got).astype(np.int64), want)


def test_approx_scores_raise_past_the_exact_width():
    d = scoring.EXACT_MAX_D + 1
    assert d * 127 ** 2 >= 2 ** 24 > (d - 1) * 127 ** 2
    with pytest.raises(ValueError, match="exact"):
        scoring.approx_scores(torch.zeros((1, 1, d), dtype=torch.int8),
                              torch.ones((1, 1)),
                              torch.zeros((1, 1, 2, d), dtype=torch.int8),
                              torch.ones((1, 1, 2)),
                              torch.ones((1, 1, 2), dtype=torch.bool))


def test_reduced_config_is_the_latent_the_tests_name():
    jcfg, tcfg, _ = _weights()
    assert dataclasses.asdict(tcfg.mla) == dataclasses.asdict(jcfg.mla)
    assert (tcfg.mla.latent_dim, tcfg.n_heads, tcfg.num_layers,
            tcfg.moe.n_experts, tcfg.moe.dense_first_k) == (40, 4, 2, 4, 1)
