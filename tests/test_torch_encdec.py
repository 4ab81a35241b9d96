"""The enc-dec family (whisper-base) in the port, against the reference.

Reduced whisper-base on both sides (2 encoder + 2 decoder blocks, d 64, 4
heads over 2 kv-heads of 16, LayerNorm, tanh-GELU, qkv bias, sinusoidal
positions, 8 encoder frames), f32, the reference's weights with the
constant leaves noised — the norms' unit `w` too, so a swapped `ln_x`
shows (`torch_parity.noisy_const_leaves`) — and inputs from numpy seeds.
Prompts of 64 tokens under unicaim(heavy=24, reserve=8, select_k=8, ...),
so the static top-k prunes and each cache's `fill` lies below its `step`:

- `sinusoidal` against `repro.models.layers.sinusoidal`;
- the encoder's bidirectional attention, `encode_cross_kv`,
  `cross_attention` (T = 5 and a decode step's T = 1) and the whole
  encoder's cross K/V against the reference's, within 1e-5 (f32 products
  in another summation order);
- `Model.prefill`: logits within 1e-4; every cache field (kept slots,
  positions, fill and step exactly; float fields within 1e-5; int8 codes
  exactly but for one-code flips where the f32 K lies within rounding
  noise of a quantization boundary, at most 1 in 1,000 codes); the cross
  K/V within 1e-5, bf16 and int8 KV, unicaim and dense;
- teacher-forced `decode_step` logits within 1e-4 from the reference's own
  prefilled state (both sides decode from the same cache codes), and from
  each side's own prefill (int8: within 1e-3, as a flipped code moves the
  logits past 1e-4); `greedy_generate` tokens exactly; fused and composed
  decode, bf16 and int8;
- `decode_step(active=...)` freezes an inactive lane bit for bit;
- the lane surgery (`lane_slice`, `lane_insert`, `lanes_insert`) with the
  cross K/V against the reference's helpers on one state, bit for bit;
- the refusals: `prefill` with a `length`, chunked and bucketed prefill,
  `ServeLoop`, a batch without `enc_embed`; and the CLI on the CPU.
"""
import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.launch.serve import _decode_step_fn, _model_key  # noqa: E402
from repro.models import attention_layer as jattn  # noqa: E402
from repro.models import layers as jlayers  # noqa: E402
from repro.models import transformer as jtrans  # noqa: E402
from repro.core.cache import KVCache as JaxKVCache  # noqa: E402
from repro_torch.core.cache import FIELDS, KVCache  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch.serve import ServeLoop  # noqa: E402
from repro_torch.models import attention_layer as tattn  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as ttrans  # noqa: E402
from repro_torch.params import from_reference  # noqa: E402
from torch_parity import decode_runs, model_pair, to_np  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCH = "whisper-base"
UNICAIM = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2,
               recent_window=8)
T, TEACHER_STEPS, GREEDY_STEPS = 64, 6, 10
ATOL = 1e-4                     # logits
FIELD_ATOL = 1e-5               # f32 cache fields, the cross K/V
FLIP_SHARE = 1e-3               # int8 codes one step apart, at most


def _models(kv="bf16", fused=True, policy="unicaim", blocks=1):
    return _pair(kv, fused, policy, blocks)


@functools.lru_cache(maxsize=None)
def _pair(kv, fused, policy, blocks):
    kw = (dict(max_seq=128) if policy == "dense" else
          dict(kv_dtype=kv, fused=fused, select_blocks=blocks, **UNICAIM))
    return model_pair(ARCH, policy, **kw)


def _batch(cfg, b=2, t=T, seed=0):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (b, t)).astype(
                np.int32),
            "enc_embed": rng.standard_normal(
                (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.as_tensor(v) for k, v in batch.items()}


def _port_state(jst) -> ttrans.DecodeState:
    """The reference's DecodeState as the port's (copies)."""
    kv = KVCache(*(None if getattr(jst.kv, f) is None
                   else torch.as_tensor(np.array(getattr(jst.kv, f)))
                   for f in FIELDS))
    return ttrans.DecodeState(kv=kv, cross=tuple(
        torch.as_tensor(np.array(a)) for a in jst.cross))


def _jax_state(st) -> jtrans.DecodeState:
    kv = JaxKVCache(*(None if getattr(st.kv, f) is None
                      else jnp.asarray(to_np(getattr(st.kv, f)))
                      for f in FIELDS))
    return jtrans.DecodeState(kv=kv, ssm=None, cross=tuple(
        jnp.asarray(to_np(a)) for a in st.cross))


# ---------------------------------------------------------------------------
# the layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", [16, 64, 512])
def test_sinusoidal_matches_reference(d):
    """The table at every position a test or the card's run uses (the
    1,500 encoder frames, prompts of 2,048 and 32 decode steps): within 2
    f32 ulps below 4,096. Up to whisper's `max_seq_len` (32,768) within
    4e-6: at d = 512 one of the 256 frequencies is one ulp apart between
    XLA's power and torch's, and its angle drifts with the position."""
    pos = np.arange(32768)
    want = np.asarray(jlayers.sinusoidal(jnp.asarray(pos)[None], d))[0]
    got = to_np(L.sinusoidal(torch.as_tensor(pos)[None], d))[0]
    assert got.shape == want.shape == (32768, d) and got.dtype == np.float32
    np.testing.assert_allclose(got[:4096], want[:4096], atol=2.5e-7, rtol=0)
    np.testing.assert_allclose(got, want, atol=4e-6, rtol=0)
    # a decode step's [B, 1] positions give [B, 1, d] rows of the table
    lanes = torch.as_tensor([[7], [2047]])
    np.testing.assert_array_equal(to_np(L.sinusoidal(lanes, d))[:, 0],
                                  got[[7, 2047]])


def _layer(tree, seg, j=0):
    return jax.tree.map(lambda a: a[j], tree[seg])


def test_encoder_and_cross_attention_match_reference():
    jm, jp, tm, tp = _models()
    cfg, jcfg = tm.cfg, jm.cfg
    assert cfg.n_heads // cfg.n_kv_heads == 2
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    enc = jp["seg0_encdec_enc"]["attn"]
    penc = ttrans.layer_params(tp["seg0_encdec_enc"], 0)["attn"]
    pos = np.arange(8)[None]
    want = jattn.attention_train(jax.tree.map(lambda a: a[0], enc),
                                 jnp.asarray(x), jcfg, jnp.asarray(pos),
                                 causal=False)
    got = tattn.attention_train(penc, torch.as_tensor(x), cfg,
                                torch.as_tensor(pos), causal=False)
    np.testing.assert_allclose(to_np(got), np.asarray(want),
                               atol=FIELD_ATOL, rtol=0)
    # bidirectional: the first row sees the last
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = tattn.attention_train(penc, torch.as_tensor(x2), cfg,
                                  torch.as_tensor(pos), causal=False) - got
    assert float(moved[:, 0].abs().max()) > 1e-3

    xattn = _layer(jp, "seg1_encdec_dec")["xattn"]
    pxattn = ttrans.layer_params(tp["seg1_encdec_dec"], 0)["xattn"]
    jkv = jattn.encode_cross_kv(xattn, jnp.asarray(x), jcfg)
    tkv = tattn.encode_cross_kv(pxattn, torch.as_tensor(x), cfg)
    for g, w in zip(tkv, jkv):
        assert tuple(g.shape) == w.shape == (2, cfg.n_kv_heads, 8,
                                             cfg.head_dim)
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=FIELD_ATOL,
                                   rtol=0)
    for t in (5, 1):
        h = rng.standard_normal((2, t, cfg.d_model)).astype(np.float32)
        want = jattn.cross_attention(xattn, jnp.asarray(h), jkv, jcfg)
        got = tattn.cross_attention(pxattn, torch.as_tensor(h), tkv, cfg)
        np.testing.assert_allclose(to_np(got), np.asarray(want),
                                   atol=FIELD_ATOL, rtol=0)


def test_encoder_cross_kv_matches_reference():
    """The whole encoder (2 blocks over the frames plus their positions)
    and every decoder layer's cross K/V from it."""
    jm, jp, tm, tp = _models()
    batch = _batch(tm.cfg)
    enc = jnp.asarray(batch["enc_embed"])
    pos = jnp.arange(enc.shape[1])[None]
    enc = enc + jlayers.sinusoidal(pos, jm.cfg.d_model)
    enc, _ = jm._scan_train(jp["seg0_encdec_enc"], enc, pos, "encdec_enc",
                            causal=False)
    want = jax.vmap(lambda pl: jattn.encode_cross_kv(pl["xattn"], enc,
                                                     jm.cfg)
                    )(jp["seg1_encdec_dec"])
    b, s_enc = batch["enc_embed"].shape[:2]
    got = tm._encode(tp, _torch(batch),
                     tm.init_decode_state(b, cross_len=s_enc).cross)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape == (2, 2, 2, 8, 16)
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=FIELD_ATOL,
                                   rtol=0)


# ---------------------------------------------------------------------------
# the tree and the state
# ---------------------------------------------------------------------------


def test_tree_and_state_shapes_match_reference():
    jm, jp, tm, tp = _models()
    assert set(tp) == set(jp) == {"embed", "final_norm", "lm_head",
                                  "frontend_adapter", "seg0_encdec_enc",
                                  "seg1_encdec_dec"}
    assert set(tp["seg1_encdec_dec"]) == {"ln1", "ln2", "ln_x", "attn",
                                          "xattn", "mlp"}
    assert set(tp["seg0_encdec_enc"]) == {"ln1", "ln2", "attn", "mlp"}
    own = tm.init(0)
    assert jax.tree.structure(jax.tree.map(lambda a: 0, own)) == \
        jax.tree.structure(jax.tree.map(lambda a: 0, dict(jp)))
    assert tm.attn_layer_count() == jm.attn_layer_count() == 2
    st, jst = tm.init_decode_state(3, cross_len=8), jm.init_decode_state(
        3, cross_len=8)
    for g, w in zip(st.cross, jst.cross):
        assert tuple(g.shape) == w.shape == (2, 3, 2, 8, 16)
        assert not g.any()
    assert tm.init_decode_state(3).cross is None
    assert st.kv.k.shape[0] == 2 and st.ssm is None


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------


def _assert_cache_equal(tc, jc):
    for f in FIELDS:
        got, want = getattr(tc, f), getattr(jc, f)
        assert (got is None) == (want is None), f
        if got is None:
            continue
        got, want = to_np(got), np.asarray(want)
        assert got.shape == want.shape and got.dtype == want.dtype, f
        if f == "k" and got.dtype == np.int8 or f == "kq":
            step = np.abs(got.astype(np.int32) - want)
            assert step.max() <= 1 and step.mean() <= FLIP_SHARE, (
                f, int((step > 0).sum()), got.size)
        elif got.dtype.kind in "iub":
            np.testing.assert_array_equal(got, want, err_msg=f)
        else:
            np.testing.assert_allclose(got, want, atol=FIELD_ATOL, rtol=0,
                                       err_msg=f)


@pytest.mark.parametrize("kv,policy", [("bf16", "unicaim"),
                                       ("int8", "unicaim"),
                                       ("bf16", "dense")])
def test_prefill_matches_reference(kv, policy):
    jm, jp, tm, tp = _models(kv, policy=policy)
    batch = _batch(tm.cfg)
    jlog, jst = jm.prefill(jp, _jax(batch))
    tlog, tst = tm.prefill(tp, _torch(batch))
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=ATOL,
                               rtol=0)
    _assert_cache_equal(tst.kv, jst.kv)
    for g, w in zip(tst.cross, jst.cross):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(to_np(g), np.asarray(w), atol=FIELD_ATOL,
                                   rtol=0)
    step = to_np(tst.kv.step)
    assert (step == T).all()
    if policy == "unicaim":          # pruned: positions != slots
        assert (to_np(tst.kv.fill) < step).all()
    # the encoder's input matters
    other = dict(_torch(batch), enc_embed=-torch.as_tensor(
        batch["enc_embed"]))
    assert float((tm.prefill(tp, other)[0] - tlog).abs().max()) > 1e-3


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def _teacher(cfg):
    return np.random.default_rng(1).integers(
        0, cfg.vocab_size, (TEACHER_STEPS, 2)).astype(np.int32)


DECODE_CASES = [("bf16", True, 1), ("int8", True, 1), ("bf16", False, 1),
                ("int8", False, 1), ("bf16", True, 2)]


@pytest.mark.parametrize("kv,fused,blocks", DECODE_CASES)
def test_decode_from_reference_state_matches_reference(kv, fused, blocks):
    """Both sides decode from the reference's prefilled state (the same
    cache codes): teacher-forced logits within 1e-4, and the port's cache
    after the steps the reference's."""
    jm, jp, tm, tp = _models(kv, fused, blocks=blocks)
    _, jst = jm.prefill(jp, _jax(_batch(tm.cfg)))
    st = _port_state(jst)
    step = _decode_step_fn(_model_key(jm))
    for tok in _teacher(tm.cfg):
        lj, jst = step(jp, jst, jnp.asarray(tok))
        lt, st = tm.decode_step(tp, st, torch.as_tensor(tok))
        np.testing.assert_allclose(to_np(lt), np.asarray(lj), atol=ATOL,
                                   rtol=0)
    _assert_cache_equal(st.kv, jst.kv)
    assert (to_np(st.kv.step) == T + TEACHER_STEPS).all()


@functools.lru_cache(maxsize=None)
def _runs(kv, fused, blocks=1, policy="unicaim"):
    jm, jp, tm, tp = _models(kv, fused, policy, blocks)
    return decode_runs(jm, jp, tm, tp, _batch(tm.cfg), _teacher(tm.cfg),
                       GREEDY_STEPS)


@pytest.mark.parametrize("kv,fused,blocks", DECODE_CASES)
def test_greedy_tokens_and_decode_logits_match_reference(kv, fused, blocks):
    """Each side from its own prefill: greedy tokens equal, teacher-forced
    logits within 1e-4 (int8 KV: 1e-3, as the two prefills may round a
    code apart)."""
    (jl, tl), (jt, tt) = _runs(kv, fused, blocks)
    np.testing.assert_allclose(tl, jl, atol=ATOL if kv == "bf16" else 1e-3,
                               rtol=0)
    np.testing.assert_array_equal(tt, jt)


def test_dense_policy_tokens_and_continuity():
    """Under the dense policy (no pruning) a decode of token t equals the
    prompt pass over t + 1 tokens: the decode's sinusoidal position is the
    prompt's next."""
    (jl, tl), (jt, tt) = _runs("bf16", True, policy="dense")
    np.testing.assert_allclose(tl, jl, atol=ATOL, rtol=0)
    np.testing.assert_array_equal(tt, jt)
    _, _, tm, tp = _models(policy="dense")
    batch = _torch(_batch(tm.cfg, t=33, seed=2))
    toks = batch["tokens"]
    _, st = tm.prefill(tp, dict(batch, tokens=toks[:, :32]))
    step, _ = tm.decode_step(tp, st, toks[:, 32])
    whole, _ = tm.prefill(tp, batch)
    np.testing.assert_allclose(to_np(step), to_np(whole), atol=ATOL, rtol=0)


def test_decode_step_active_freezes_a_lane():
    _, _, tm, tp = _models()
    batch = _torch(_batch(tm.cfg, b=3, seed=3))
    _, st = tm.prefill(tp, batch)
    before, free = st.clone(), st.clone()
    tok = batch["tokens"][:, -1]
    _, free = tm.decode_step(tp, free, tok)
    active = torch.tensor([True, False, True])
    _, st = tm.decode_step(tp, st, tok, active)
    for f in FIELDS:
        got = getattr(st.kv, f)
        if got is None:
            continue
        old, new = getattr(before.kv, f), getattr(free.kv, f)
        assert torch.equal(got[:, 1], old[:, 1]), f
        assert torch.equal(got[:, active], new[:, active]), f
    assert all(torch.equal(a, b) for a, b in zip(st.cross, before.cross))
    assert not torch.equal(free.kv.step[:, 1], before.kv.step[:, 1])


# ---------------------------------------------------------------------------
# lane surgery
# ---------------------------------------------------------------------------


def _assert_states_equal(st, jst):
    for f in FIELDS:
        got, want = getattr(st.kv, f), getattr(jst.kv, f)
        assert (got is None) == (want is None), f
        if got is not None:
            np.testing.assert_array_equal(to_np(got), np.asarray(want),
                                          err_msg=f)
    for g, w in zip(st.cross, jst.cross):
        np.testing.assert_array_equal(to_np(g), np.asarray(w))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_lane_surgery_carries_cross_as_the_reference(kv):
    """One live batch-3 state and one fresh batch-2 state, from the port's
    prefill of different prompts and frames, through both packages'
    helpers: every cache field and the cross K/V bit for bit."""
    _, _, tm, tp = _models(kv)
    _, live = tm.prefill(tp, _torch(_batch(tm.cfg, b=3, seed=4)))
    _, fresh = tm.prefill(tp, _torch(_batch(tm.cfg, b=2, seed=5)))
    jlive, jfresh = _jax_state(live), _jax_state(fresh)

    one = ttrans.lane_slice(fresh, 1)
    jone = jtrans.lane_slice(jfresh, 1)
    _assert_states_equal(one, jone)
    assert one.cross[0].shape[1] == 1

    got = ttrans.lane_insert(live.clone(), 2, one)
    _assert_states_equal(got, jtrans.lane_insert(jlive, 2, jone))
    assert not torch.equal(got.cross[0][:, 2], live.cross[0][:, 2])

    src = [1, -1, 0]
    got = ttrans.lanes_insert(live.clone(), src, fresh)
    _assert_states_equal(got, jtrans.lanes_insert(jlive, jnp.asarray(src),
                                                  jfresh))
    assert torch.equal(got.cross[1][:, 1], live.cross[1][:, 1])
    # a lane merge keeps the decode step's (unwritten) cross K/V
    merged = ttrans.lane_select(torch.tensor([True, False, True]), live,
                                live.clone())
    assert merged.cross is live.cross


# ---------------------------------------------------------------------------
# refusals and the CLI
# ---------------------------------------------------------------------------


def test_refusals_match_reference():
    jm, jp, tm, tp = _models()
    batch = _batch(tm.cfg)
    length = np.full(2, T, np.int32)
    with pytest.raises(ValueError, match="bucketed prefill"):
        jm.prefill(jp, dict(_jax(batch), length=jnp.asarray(length)))
    with pytest.raises(ValueError, match="bucketed prefill"):
        tm.prefill(tp, dict(_torch(batch), length=torch.as_tensor(length)))
    assert jm.supports_chunked_prefill() is tm.supports_chunked_prefill() \
        is False
    assert jm.supports_bucketed_prefill() is tm.supports_bucketed_prefill() \
        is False
    with pytest.raises(ValueError, match="enc_embed"):
        tm.prefill(tp, {"tokens": torch.as_tensor(batch["tokens"])})
    with pytest.raises(ValueError, match="token prompts.*enc_embed"):
        ServeLoop(tm, tp, lanes=2, device="cpu")


def test_from_reference_keeps_the_encdec_tree():
    jm, jp, tm, tp = _models()
    tree = jax.tree.map(np.asarray, jp)
    again = from_reference(tree)
    for name in ("ln_x", "xattn"):
        for leaf, want in tree["seg1_encdec_dec"][name].items():
            np.testing.assert_array_equal(
                to_np(again["seg1_encdec_dec"][name][leaf]), want)


@pytest.mark.parametrize("extra", [[], ["--no-scan"]])
def test_cli_runs_whisper_on_the_cpu(extra, capsys):
    tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "40", "--new-tokens", "4"] + extra)
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and "generated (2, 4)" in out, out
    with pytest.raises(ValueError, match="token prompts"):
        tserve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--serve"])
