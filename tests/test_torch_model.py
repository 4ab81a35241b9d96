"""Parity of the port's dense model with the reference at reduced size.

Reduced longchat-7b (MHA) and granite-3-2b (GQA, tied embeddings), f32,
bf16 and int8 KV, fused and composed decode, the same weights on both sides
(`repro_torch.params`): prefill logits and teacher-forced decode logits to
1e-4, greedy token streams exactly. Also `chunked_causal_attention` with
`length` and `obs_window`, to 1e-5.
"""
import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.attention import (  # noqa: E402
    chunked_causal_attention as jax_chunked)
from repro.launch.serve import (  # noqa: E402
    _decode_step_fn, _model_key, _prefill_fn)
from repro.launch.serve import greedy_generate as jax_greedy  # noqa: E402
from repro_torch.core.attention import chunked_causal_attention  # noqa: E402
from repro_torch.launch.serve import greedy_generate  # noqa: E402
from torch_parity import model_pair, to_np  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["longchat-7b", "granite-3-2b"]
# 40-token prompts into 24+8 slots: the static top-k prunes, the cache
# fills after 8 decode steps, and eviction runs for the rest
UNICAIM = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2,
               recent_window=8)
PROMPT_LEN, SHORT_LEN = 40, 29
TEACHER_STEPS, GREEDY_STEPS = 8, 16


def _batch(vocab, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, (2, PROMPT_LEN)).astype(np.int32)
    tokens[1, SHORT_LEN:] = 0                  # right-padded second prompt
    return tokens, np.array([PROMPT_LEN, SHORT_LEN], np.int32)


@functools.lru_cache(maxsize=None)
def _runs(arch, kv, fused):
    """Both sides' prefill logits, 8 teacher-forced decode logits, and 16
    greedy tokens, computed once per case."""
    jm, jp, tm, tp = model_pair(arch, kv_dtype=kv, fused=fused, **UNICAIM)
    tokens, length = _batch(tm.cfg.vocab_size)
    jbatch = {"tokens": jnp.asarray(tokens), "length": jnp.asarray(length)}
    tbatch = {"tokens": torch.as_tensor(tokens),
              "length": torch.as_tensor(length)}
    teacher = np.random.default_rng(1).integers(
        0, tm.cfg.vocab_size, (TEACHER_STEPS, 2)).astype(np.int32)
    out = {}
    jlog, jst = _prefill_fn(_model_key(jm))(jp, jbatch)
    tlog, tst = tm.prefill(tp, tbatch)
    out["prefill"] = (to_np(jlog), to_np(tlog))
    step = _decode_step_fn(_model_key(jm))
    jl, tl = [], []
    for tok in teacher:
        lj, jst = step(jp, jst, jnp.asarray(tok))
        lt, tst = tm.decode_step(tp, tst, torch.as_tensor(tok))
        jl.append(to_np(lj))
        tl.append(to_np(lt))
    out["teacher"] = (np.stack(jl), np.stack(tl))
    jtoks, _ = jax_greedy(jm, jp, jbatch, GREEDY_STEPS)
    ttoks, _ = greedy_generate(tm, tp, tbatch, GREEDY_STEPS, device="cpu")
    out["greedy"] = (to_np(jtoks), to_np(ttoks))
    return out


CASES = [(a, kv, f) for a in ARCHS for kv in ("bf16", "int8")
         for f in (True, False)]


@pytest.mark.parametrize("arch,kv,fused", CASES)
def test_prefill_logits_match_reference(arch, kv, fused):
    j, t = _runs(arch, kv, fused)["prefill"]
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch,kv,fused", CASES)
def test_teacher_forced_decode_logits_match_reference(arch, kv, fused):
    j, t = _runs(arch, kv, fused)["teacher"]
    np.testing.assert_allclose(t, j, atol=1e-4, rtol=0)


@pytest.mark.parametrize("arch,kv,fused", CASES)
def test_greedy_tokens_equal_reference(arch, kv, fused):
    j, t = _runs(arch, kv, fused)["greedy"]
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("policy,kw", [
    ("dense", dict(max_seq=64)),
    ("streaming", dict(budget=24)),
    ("h2o", dict(heavy=24, reserve=8, recent=8)),
])
def test_baseline_policies_greedy_tokens_equal_reference(policy, kw):
    """The dense/streaming/h2o decode paths the CLI's --policy reaches."""
    jm, jp, tm, tp = model_pair("granite-3-2b", policy=policy, **kw)
    tokens, length = _batch(tm.cfg.vocab_size, seed=3)
    jtoks, _ = jax_greedy(jm, jp, {"tokens": jnp.asarray(tokens),
                                   "length": jnp.asarray(length)}, 12)
    ttoks, _ = greedy_generate(tm, tp, {"tokens": torch.as_tensor(tokens),
                                        "length": torch.as_tensor(length)},
                               12, device="cpu")
    np.testing.assert_array_equal(to_np(ttoks), to_np(jtoks))


@pytest.mark.parametrize("hq,hk,length,obs,chunk", [
    (4, 4, None, 0, 16),
    (4, 2, [37, 20], 0, 16),
    (8, 2, [37, 11], 8, 12),
])
def test_chunked_causal_attention_matches_reference(hq, hk, length, obs,
                                                    chunk):
    rng = np.random.default_rng(hq + obs)
    b, n, d = 2, 37, 16
    q = rng.standard_normal((b, hq, n, d)).astype(np.float32)
    k = rng.standard_normal((b, hk, n, d)).astype(np.float32)
    v = rng.standard_normal((b, hk, n, d)).astype(np.float32)
    ln = None if length is None else np.asarray(length, np.int32)
    jo, ja = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         chunk=chunk, obs_window=obs,
                         length=None if ln is None else jnp.asarray(ln))
    to, ta = chunked_causal_attention(
        torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
        chunk=chunk, obs_window=obs,
        length=None if ln is None else torch.as_tensor(ln))
    live = (np.arange(n)[None, :] < (n if ln is None else ln)[..., None]
            if ln is not None else np.ones((b, n), bool))
    # outputs at pad rows are not meaningful on either side
    np.testing.assert_allclose(to_np(to)[live[:, None, :].repeat(hq, 1)],
                               to_np(jo)[live[:, None, :].repeat(hq, 1)],
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(to_np(ta), to_np(ja), atol=1e-5, rtol=0)
