"""Chunked (time-sliced) prefill in the port, against the reference and
against the port's own whole-bucket prefill.

Reduced longchat-7b (MHA) and granite-3-2b (GQA), bf16 and int8 KV, the
same weights on both sides (`tests/torch_parity.py`): `prefill_chunk` x n
+ `prefill_finalize` of a 40-token prompt in a 64-token bucket, C = 16,
against the reference's (logits to 1e-4, as the prefill of
`test_torch_model.py`; every cache field, floats to 1e-5, quantized codes,
kept slots and counts exactly), against the port's whole-bucket prefill
(greedy tokens and kept slots equal), and resumed from an earlier chunk
state (equal to the run from row 0 bit for bit). `ServeLoop(chunk_prefill=
16)`: streams equal whole-bucket admission and the reference's
`ServeLoop(chunk_prefill=16)` on one arrival trace; the CLI flag.
"""
import functools
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro_torch.core.cache import FIELDS  # noqa: E402
from repro_torch.launch.serve import (Request, ServeLoop,  # noqa: E402
                                      decode_block, main)
from torch_parity import model_pair, to_np  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

ARCHS = ["longchat-7b", "granite-3-2b"]
UNICAIM = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2,
               recent_window=8)
T, BUCKET, C = 40, 64, 16
CASES = [(a, kv) for a in ARCHS for kv in ("bf16", "int8")]
# the arrival trace of test_torch_serve.py
SERVE_PRUNE = dict(heavy=24, reserve=8, select_k=8, sink_tokens=2,
                   recent_window=8)
SERVE_LENS = [20, 9, 33, 17, 12, 40, 30]
SERVE_BUDGETS = [6, 10, 4, 9, 3, 7, 5]


@functools.lru_cache(maxsize=None)
def _pair(arch, kv):
    return model_pair(arch, kv_dtype=kv, fused=True, **UNICAIM)


def _prompt(vocab, t=T, seed=0):
    rng = np.random.default_rng(seed)
    padded = np.zeros(BUCKET, np.int64)
    padded[:t] = rng.integers(0, vocab, t)
    return padded


def _port_chunked(tm, tp, padded, t, start=0, pstate=None):
    """Chunks from row `start` (of a fresh workspace unless given), then
    finalize → (logits, state, workspace)."""
    ps = pstate if pstate is not None else tm.init_prefill_chunk_state(
        1, BUCKET)
    length = torch.as_tensor([t])
    n = math.ceil(t / C)
    x = None
    for ci in range(start // C, n):
        x, ps = tm.prefill_chunk(tp, ps, torch.as_tensor(
            padded[None, ci * C:(ci + 1) * C]), ci * C, length)
    logits, st = tm.prefill_finalize(tp, ps, x, (n - 1) * C, length)
    return logits, st, ps


def _assert_cache_close(t, j):
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert (a is None) == (b is None), f
        if a is None:
            continue
        a, b = to_np(a), np.asarray(b)
        assert a.shape == b.shape, (f, a.shape, b.shape)
        if b.dtype.kind == "f":
            np.testing.assert_allclose(a.astype(np.float32),
                                       b.astype(np.float32), atol=1e-5,
                                       rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(a, b.astype(a.dtype), err_msg=f)


@pytest.mark.parametrize("arch,kv", CASES)
def test_chunked_prefill_matches_reference(arch, kv):
    jm, jp, tm, tp = _pair(arch, kv)
    padded = _prompt(tm.cfg.vocab_size)
    ps = jm.init_prefill_chunk_state(1, BUCKET)
    chunk = jax.jit(jm.prefill_chunk)
    n = math.ceil(T / C)
    x = None
    for ci in range(n):
        x, ps = chunk(jp, ps, jnp.asarray(padded[None, ci * C:(ci + 1) * C]),
                      jnp.asarray(ci * C, jnp.int32), jnp.asarray([T]))
    jlog, jst = jax.jit(jm.prefill_finalize)(
        jp, ps, x, jnp.asarray((n - 1) * C, jnp.int32), jnp.asarray([T]))
    tlog, tst, tps = _port_chunked(tm, tp, padded, T)
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    _assert_cache_close(tst.kv, jst.kv)
    for name in ("k", "v", "acc"):             # the streamed workspace
        np.testing.assert_allclose(to_np(getattr(tps, name)),
                                   np.asarray(getattr(ps, name)), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("arch,kv", CASES)
def test_chunked_prefill_matches_whole_bucket_prefill(arch, kv):
    _, _, tm, tp = _pair(arch, kv)
    padded = _prompt(tm.cfg.vocab_size, seed=1)
    wlog, wst = tm.prefill(tp, {"tokens": torch.as_tensor(padded[None]),
                                "length": torch.as_tensor([T])})
    clog, cst, _ = _port_chunked(tm, tp, padded, T)
    torch.testing.assert_close(clog, wlog, rtol=0, atol=1e-5)
    assert torch.equal(cst.kv.pos, wst.kv.pos)           # the kept slots
    assert torch.equal(cst.kv.valid, wst.kv.valid)
    toks = [decode_block(tm, tp, st, torch.argmax(lg, -1), 12)[2]
            for lg, st in ((wlog, wst), (clog, cst))]
    assert torch.equal(toks[0], toks[1])


@pytest.mark.parametrize("arch,kv", CASES)
def test_resume_prefill_chunk_state_equals_run_from_row_zero(arch, kv):
    _, _, tm, tp = _pair(arch, kv)
    assert tm.supports_chunked_prefill()
    padded = _prompt(tm.cfg.vocab_size, seed=2)
    p = 16
    ps = tm.init_prefill_chunk_state(1, BUCKET)
    tm.prefill_chunk(tp, ps, torch.as_tensor(padded[None, :p]), 0,
                     torch.as_tensor([T]))
    rows = (ps.k[:, 0, :, :p].clone(), ps.v[:, 0, :, :p].clone(),
            ps.acc[:, 0, :, :p].clone())
    resumed = tm.resume_prefill_chunk_state(*rows, bucket=BUCKET)
    rlog, rst, rps = _port_chunked(tm, tp, padded, T, start=p,
                                   pstate=resumed)
    flog, fst, fps = _port_chunked(tm, tp, padded, T)
    assert torch.equal(rlog, flog)
    for name in ("k", "v", "acc"):
        assert torch.equal(getattr(rps, name), getattr(fps, name)), name
    for f in FIELDS:
        a, b = getattr(rst.kv, f), getattr(fst.kv, f)
        assert (a is None and b is None) or torch.equal(a, b), f


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_one_matches_reference(arch):
    """Logits to 1e-4 and the kept slots exactly (the codes of a whole
    prefill may differ by one at a float near-tie, as in
    `test_torch_model.py`), and equal to the port's batch-1 prefill."""
    jm, jp, tm, tp = _pair(arch, "int8")
    padded = _prompt(tm.cfg.vocab_size, seed=3)
    jlog, jst = jm.prefill_one(jp, jnp.asarray(padded), length=T)
    tlog, tst = tm.prefill_one(tp, torch.as_tensor(padded), length=T)
    assert tlog.shape == (tm.cfg.vocab_size,)
    np.testing.assert_allclose(to_np(tlog), np.asarray(jlog), atol=1e-4,
                               rtol=0)
    for f in ("pos", "valid", "fill", "step"):
        np.testing.assert_array_equal(to_np(getattr(tst.kv, f)),
                                      np.asarray(getattr(jst.kv, f)))
    blog, bst = tm.prefill(tp, {"tokens": torch.as_tensor(padded[None]),
                                "length": torch.as_tensor([T])})
    assert torch.equal(tlog, blog[0])
    assert torch.equal(tst.kv.k, bst.kv.k)


# ---------------------------------------------------------------------------
# ServeLoop(chunk_prefill=16)
# ---------------------------------------------------------------------------


def _streams(loop, trace):
    handles = [loop.submit(Request(prompt=p, max_new=m)) for p, m in trace]
    loop.run()
    assert all(h.done for h in handles)
    return handles


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_chunked_admission_streams_equal_whole_admission(kv):
    _, _, tm, tp = _pair("granite-3-2b", kv)
    reqs = [(40, 4), (64, 6), (24, 3), (57, 5), (8, 2)]
    rng = np.random.default_rng(60)
    trace = [(rng.integers(0, tm.cfg.vocab_size, t), m) for t, m in reqs]
    whole = _streams(ServeLoop(tm, tp, lanes=2, block=2, device="cpu"),
                     trace)
    sliced_loop = ServeLoop(tm, tp, lanes=2, block=2, chunk_prefill=16,
                            device="cpu")
    sliced = _streams(sliced_loop, trace)
    for (t, _), hw, hs in zip(reqs, whole, sliced):
        assert hs.tokens == hw.tokens, t
        assert hs.stats.prefill_chunks == (math.ceil(t / 16) if t > 16 else 1)
    c = sliced_loop.counters
    assert c["chunk_dispatches"] == sum(math.ceil(t / 16) for t, _ in reqs
                                        if t > 16)
    assert sliced_loop._pending is None and not sliced_loop.active.any()


def test_chunked_admission_rounds_a_ragged_bucket_up():
    """Exact-length prompts (buckets=None): a 57-token prompt runs 4 full
    16-token slices over a 64-row workspace."""
    _, _, tm, tp = _pair("granite-3-2b", "bf16")
    prompt = np.random.default_rng(71).integers(0, tm.cfg.vocab_size, 57)
    whole = _streams(ServeLoop(tm, tp, lanes=2, block=2, buckets=None,
                               device="cpu"), [(prompt, 4)])
    loop = ServeLoop(tm, tp, lanes=2, block=2, buckets=None,
                     chunk_prefill=16, device="cpu")
    (h,) = _streams(loop, [(prompt, 4)])
    assert h.tokens == whole[0].tokens
    assert h.stats.prefill_chunks == 4 and h.stats.bucket == 64
    assert loop.counters["chunk_dispatches"] == 4


def test_model_without_chunked_prefill_falls_back_to_whole_admission(
        monkeypatch):
    _, _, tm, tp = _pair("granite-3-2b", "bf16")
    monkeypatch.setattr(tm, "supports_chunked_prefill", lambda: False)
    prompt = np.random.default_rng(72).integers(0, tm.cfg.vocab_size, 40)
    loop = ServeLoop(tm, tp, lanes=2, block=2, chunk_prefill=16,
                     device="cpu")
    assert loop.chunk_prefill == 0
    (h,) = _streams(loop, [(prompt, 3)])
    assert h.stats.prefill_chunks == 1 and h.done
    assert loop.counters["chunk_dispatches"] == 0


def test_one_sliced_prefill_at_a_time_short_prompts_pass_it():
    """While a long prompt is sliced, a second long one waits and a short
    one is admitted into a free lane."""
    _, _, tm, tp = _pair("granite-3-2b", "bf16")
    rng = np.random.default_rng(5)
    loop = ServeLoop(tm, tp, lanes=3, block=2, chunk_prefill=16,
                     device="cpu")
    trace = [(rng.integers(0, tm.cfg.vocab_size, t), 3) for t in (60, 50, 9)]
    for p, m in trace:
        loop.submit(Request(prompt=p, max_new=m))
    loop.schedule()
    assert loop._pending is not None and loop._pending.req.rid == 0
    assert [r.rid for r in loop.queue] == [1]      # the short one went in
    assert loop.stats[2].lane >= 0
    loop.run()
    assert [s.prefill_chunks for s in sorted(loop.completed,
                                             key=lambda s: s.rid)] == [4, 4, 1]


def test_chunked_admission_streams_equal_reference_serve_loop():
    """The arrival trace of `test_torch_serve.py`, with chunk_prefill=16
    on both sides: every stream identical, the same slices dispatched."""
    jm, jp, tm, tp = model_pair("longchat-7b", fused=True, **SERVE_PRUNE)
    rng = np.random.default_rng(4)
    trace = [(rng.integers(0, tm.cfg.vocab_size, n), m)
             for n, m in zip(SERVE_LENS, SERVE_BUDGETS)]
    jloop = JaxServeLoop(jm, jp, lanes=3, block=4, chunk_prefill=16)
    tloop = ServeLoop(tm, tp, lanes=3, block=4, chunk_prefill=16,
                      device="cpu")
    jh = [jloop.submit(JaxRequest(prompt=p, max_new=m)) for p, m in trace]
    th = _streams(tloop, trace)
    jloop.run()
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert ([h.stats.prefill_chunks for h in th]
            == [h.stats.prefill_chunks for h in jh])
    assert (tloop.counters["chunk_dispatches"]
            == jloop.counters["chunk_dispatches"] > 0)


def test_cli_serves_with_chunked_prefill(capsys):
    main(["--reduced", "--batch", "2", "--prompt-len", "40",
          "--new-tokens", "4", "--fused", "--serve", "--chunk-prefill", "16",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "served 4 reqs on 2 lanes" in out
    assert "chunks=3" in out and " 0 chunk " not in out
