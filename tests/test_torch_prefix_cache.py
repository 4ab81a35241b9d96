"""The port's prefix cache against the reference's, and against its own
cold loop.

Reduced longchat-7b (and granite-3-2b where cheap), f32 weights on both
sides (`tests/torch_parity.py`), `attn_chunk` = 16 = the chunk size, so a
whole-bucket prefill and a chunked one sum the column sums in one order:
- the radix trie: the reference's four trie tests, run on both
  `PrefixCache` classes; the byte count of a port `DecodeState`;
- `prefix_slot_aligned` / `cache_prefix_rows` equal the reference's on the
  same prefilled caches (aligned, pruned, int8);
- a chunked prefill resumed from a rows entry equals the port's own run
  from row 0 bit for bit, and the reference's within the chunked
  tolerance of `test_torch_chunked_prefill.py` (the reference's own
  cross-program resume is not bitwise under this jax);
- one arrival trace with shared prefixes, exact repeats and a
  whole-bucket donor through the reference `ServeLoop(prefix_cache_bytes=
  ...)` and the port's: streams, counters and per-request reuse equal;
- the port alone against its cold loop: equal streams, exact hits with no
  prefill, the opt-out, LRU eviction under a small budget, and no aliasing
  between the trie and live lane state or the workspace;
- the `repro_torch.surgery` names, and the CLI's `--prefix-cache`.
"""
import functools
import importlib

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core import cache as jcache  # noqa: E402
from repro.launch.serve import Request as JaxRequest  # noqa: E402
from repro.launch.serve import ServeLoop as JaxServeLoop  # noqa: E402
from repro_torch.core import cache as tcache  # noqa: E402
from repro_torch.core.cache import FIELDS, KVCache  # noqa: E402
from repro_torch.launch import prefix_cache as tpc  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop, main  # noqa: E402
from torch_parity import model_pair, to_np  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

C = 16                                   # chunk_prefill == attn_chunk
PRUNE = dict(heavy=48, reserve=16, select_k=16, sink_tokens=2,
             recent_window=8)
BUDGET = 64 << 20
TRIE_MODULES = ["repro.launch.prefix_cache", "repro_torch.launch.prefix_cache"]


@functools.lru_cache(maxsize=None)
def _pair(arch, kv):
    return model_pair(arch, cfg_kw=dict(attn_chunk=C), kv_dtype=kv,
                      fused=True, **PRUNE)


def _prompt(vocab, t, seed):
    return np.random.default_rng(seed).integers(0, vocab, t)


# ---------------------------------------------------------------------------
# the trie: the reference's tests on both classes
# ---------------------------------------------------------------------------


def _rows(mod, depth, seed=0, nbytes=None):
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal((2, 2, depth, 4)),
              rng.standard_normal((2, 2, depth, 4)),
              rng.standard_normal((2, 2, depth))]
    if mod.__name__.startswith("repro_torch"):
        arrays = [torch.as_tensor(a) for a in arrays]
    e = mod.RowsEntry(depth, *arrays)
    if nbytes is not None:
        e.nbytes = nbytes
    return e


@pytest.fixture(params=TRIE_MODULES)
def trie(request):
    return importlib.import_module(request.param)


def test_trie_longest_prefix_match(trie):
    pc = trie.PrefixCache(1 << 30)
    toks = list(range(100, 164))                     # 64 distinct tokens
    pc.insert_rows(toks[:16], _rows(trie, 16))
    pc.insert_rows(toks[:48], _rows(trie, 48))
    assert pc.match_rows(toks, cap=64).depth == 48
    assert pc.match_rows(toks, cap=32).depth == 16
    assert pc.match_rows(toks, cap=8) is None
    fork = toks[:32] + [7] * 32
    assert pc.match_rows(fork, cap=64).depth == 16
    pc.insert_state(toks, trie.StateEntry(64, 64, np.zeros(8),
                                          {"x": np.zeros(4)}))
    assert pc.match_state(toks).length == 64
    assert pc.match_state(toks[:48]) is None
    assert pc.match_state(toks + [1]) is None


def test_trie_edge_split_preserves_entries(trie):
    pc = trie.PrefixCache(1 << 30)
    a = [1, 2, 3, 4, 5, 6]
    b = [1, 2, 3, 9, 9, 9]
    pc.insert_rows(a, _rows(trie, 6))
    pc.insert_rows(b, _rows(trie, 6, seed=1))
    assert pc.match_rows(a, cap=6).depth == 6
    assert pc.match_rows(b, cap=6).depth == 6
    assert pc.match_rows([1, 2, 3, 4], cap=6) is None
    assert pc.entries == 2


def test_trie_lru_eviction_under_byte_budget(trie):
    pc = trie.PrefixCache(250)                       # room for two
    pc.insert_rows([1], _rows(trie, 1, nbytes=100))
    pc.insert_rows([2], _rows(trie, 1, seed=1, nbytes=100))
    assert pc.entries == 2 and pc.evictions == 0
    assert pc.match_rows([1, 5], cap=1).depth == 1   # [2] is now the LRU
    pc.insert_rows([3], _rows(trie, 1, seed=2, nbytes=100))
    assert pc.entries == 2 and pc.evictions == 1
    assert pc.match_rows([2, 5], cap=1) is None
    assert pc.match_rows([1, 5], cap=1) is not None
    assert pc.match_rows([3, 5], cap=1) is not None
    assert pc.bytes == 200


def test_trie_oversized_and_disabled_inserts_refused(trie):
    pc = trie.PrefixCache(50)
    assert not pc.insert_rows([1, 2], _rows(trie, 2, nbytes=100))
    assert pc.entries == 0 and pc.bytes == 0
    off = trie.PrefixCache(0)
    assert not off.insert_rows([1], _rows(trie, 1))
    assert off.match_rows([1], cap=1) is None


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_tree_nbytes_counts_port_decode_state(kv):
    """The reference counts ndarray leaves only; the port's state is a
    dataclass of torch tensors and must count every one of them."""
    _, _, tm, _ = _pair("longchat-7b", kv)
    st = tm.init_decode_state(1)
    want = sum(getattr(st.kv, f).numel() * getattr(st.kv, f).element_size()
               for f in FIELDS if getattr(st.kv, f) is not None)
    assert want > 0
    assert tpc._tree_nbytes(st) == want
    logits = torch.zeros(tm.cfg.vocab_size)
    entry = tpc.StateEntry(4, 16, logits, st)
    assert entry.nbytes == want + 4 * tm.cfg.vocab_size
    rows = tpc.RowsEntry(4, st.kv.k[:, 0], st.kv.v[:, 0], st.kv.acc[:, 0])
    assert rows.nbytes == (2 * st.kv.k[:, 0].numel() * st.kv.k.element_size()
                           + 4 * st.kv.acc[:, 0].numel())


# ---------------------------------------------------------------------------
# the slot-alignment gate
# ---------------------------------------------------------------------------


def _ref_cache_to_port(kv) -> KVCache:
    return KVCache(*(None if a is None else torch.as_tensor(np.array(a))
                     for a in kv))


@pytest.mark.parametrize("case", ["aligned", "pruned", "int8"])
@pytest.mark.parametrize("arch", ["longchat-7b", "granite-3-2b"])
def test_slot_alignment_equals_reference(arch, case):
    """A prompt within the heavy budget keeps every token (aligned); a
    longer one is pruned; an int8 cache is never a donor. Each side's gate
    on its own prefill agrees, the port's gate on the reference's cache
    gives the reference's rows exactly, and the rows of the two prefills
    agree within the prefill tolerance."""
    kv = "int8" if case == "int8" else "bf16"
    jm, jp, tm, tp = _pair(arch, kv)
    t = 64 if case == "pruned" else 16
    prompt = _prompt(tm.cfg.vocab_size, t, seed=1)
    _, jst = jm.prefill_one(jp, jnp.asarray(prompt), length=t)
    _, tst = tm.prefill_one(tp, torch.as_tensor(prompt), length=t)
    want = case == "aligned"
    assert jcache.prefix_slot_aligned(jst.kv, t) is want
    assert tcache.prefix_slot_aligned(tst.kv, t) is want
    assert tcache.prefix_slot_aligned(_ref_cache_to_port(jst.kv), t) is want
    jrows = jcache.cache_prefix_rows(jst.kv, t)
    trows = tcache.cache_prefix_rows(tst.kv, t)
    if not want:
        assert jrows is None and trows is None
        assert tcache.cache_prefix_rows(_ref_cache_to_port(jst.kv),
                                        t) is None
        return
    same = tcache.cache_prefix_rows(_ref_cache_to_port(jst.kv), t)
    for a, b, c in zip(same, jrows, trows):
        np.testing.assert_array_equal(to_np(a), b)
        assert c.device.type == "cpu" and c.shape == a.shape
        np.testing.assert_allclose(to_np(c), b, atol=1e-5, rtol=0)


def test_prefix_rows_are_copies():
    _, _, tm, tp = _pair("longchat-7b", "bf16")
    prompt = _prompt(tm.cfg.vocab_size, 16, seed=2)
    _, st = tm.prefill_one(tp, torch.as_tensor(prompt), length=16)
    k, v, acc = tcache.cache_prefix_rows(st.kv, 16)
    saved = (k.clone(), v.clone(), acc.clone())
    for f in ("k", "v", "acc"):
        getattr(st.kv, f).add_(1)
    for got, want in zip((k, v, acc), saved):
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# resume from cached rows
# ---------------------------------------------------------------------------


def _chunks(tm, tp, ps, toks, lo, hi, t):
    x = None
    for ci in range(lo, hi):
        x, ps = tm.prefill_chunk(tp, ps, torch.as_tensor(
            toks[None, ci * C:(ci + 1) * C]), ci * C, torch.as_tensor([t]))
    return x, ps


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("arch", ["longchat-7b", "granite-3-2b"])
def test_resume_from_cached_rows_bitwise(arch, kv):
    """Rows snapped at boundary 48 of prompt A (a copy, as the serving
    loop takes it), resumed with prompt B's last chunk, equal B's chunked
    prefill from row 0 bit for bit: the workspace, the logits and every
    cache field (kept slots, codes). Against the reference's resume: the
    chunked tolerance (logits 1e-4, cache floats 1e-5, codes and kept
    slots exactly)."""
    jm, jp, tm, tp = _pair(arch, kv)
    t, bucket = 64, 64
    shared = _prompt(tm.cfg.vocab_size, 48, seed=3)
    a = np.concatenate([shared, _prompt(tm.cfg.vocab_size, 16, seed=4)])
    b = np.concatenate([shared, _prompt(tm.cfg.vocab_size, 16, seed=5)])
    _, ps = _chunks(tm, tp, tm.init_prefill_chunk_state(1, bucket), a, 0, 3,
                    t)
    snap = tpc.RowsEntry(48, *(getattr(ps, f)[:, 0, :, :48].to(
        "cpu", copy=True) for f in ("k", "v", "acc")))
    ps_r = tm.resume_prefill_chunk_state(snap.k, snap.v, snap.acc, bucket)
    x_r, ps_r = _chunks(tm, tp, ps_r, b, 3, 4, t)
    lg_r, st_r = tm.prefill_finalize(tp, ps_r, x_r, 48, torch.as_tensor([t]))
    x_f, ps_f = _chunks(tm, tp, tm.init_prefill_chunk_state(1, bucket), b, 0,
                        4, t)
    lg_f, st_f = tm.prefill_finalize(tp, ps_f, x_f, 48, torch.as_tensor([t]))
    assert torch.equal(lg_r, lg_f)
    for f in ("k", "v", "acc"):
        assert torch.equal(getattr(ps_r, f), getattr(ps_f, f)), f
    for f in FIELDS:
        x, y = getattr(st_r.kv, f), getattr(st_f.kv, f)
        assert (x is None and y is None) or torch.equal(x, y), f

    # the reference's resume from its own snapshot of A
    chunk = jax.jit(jm.prefill_chunk)
    length = jnp.asarray([t])
    jps = jm.init_prefill_chunk_state(1, bucket)
    for ci in range(3):
        _, jps = chunk(jp, jps, jnp.asarray(a[None, ci * C:(ci + 1) * C]),
                       jnp.asarray(ci * C, jnp.int32), length)
    jps = jm.resume_prefill_chunk_state(
        *(np.asarray(getattr(jps, f)[:, 0, :, :48]) for f in ("k", "v",
                                                             "acc")), bucket)
    jx, jps = chunk(jp, jps, jnp.asarray(b[None, 48:64]),
                    jnp.asarray(48, jnp.int32), length)
    jlg, jst = jax.jit(jm.prefill_finalize)(jp, jps, jx,
                                            jnp.asarray(48, jnp.int32),
                                            length)
    np.testing.assert_allclose(to_np(lg_r), np.asarray(jlg), atol=1e-4,
                               rtol=0)
    for f in FIELDS:
        x, y = getattr(st_r.kv, f), getattr(jst.kv, f)
        assert (x is None) == (y is None), f
        if x is None:
            continue
        x, y = to_np(x), np.asarray(y)
        if y.dtype.kind == "f":
            np.testing.assert_allclose(x.astype(np.float32),
                                       y.astype(np.float32), atol=1e-5,
                                       rtol=0, err_msg=f)
        else:
            np.testing.assert_array_equal(x, y.astype(x.dtype), err_msg=f)


# ---------------------------------------------------------------------------
# one arrival trace through both ServeLoops
# ---------------------------------------------------------------------------


def _trace(vocab):
    """Three rounds (each submitted after the last one ran): A = P + a and
    an unrelated short H; a 16-token S (a whole-bucket donor: no token
    pruned, length on the chunk grid); then B = P + b (resumes at 32),
    A again and H again (exact hits, sliced and whole-bucket), G = P[:16]
    + 20 new (resumes at 16) and L = S + 30 new (resumes from S's rows)."""
    rng = np.random.default_rng(0)
    p = rng.integers(0, vocab, 32)
    a = np.concatenate([p, rng.integers(0, vocab, 16)])
    h = rng.integers(0, vocab, 12)
    s = rng.integers(0, vocab, 16)
    b = np.concatenate([p, rng.integers(0, vocab, 16)])
    g = np.concatenate([p[:16], rng.integers(0, vocab, 20)])
    ln = np.concatenate([s, rng.integers(0, vocab, 30)])
    return [[(a, 6), (h, 5)], [(s, 4)],
            [(b, 6), (a, 5), (g, 4), (h, 6), (ln, 5)]]


def _drive(loop, make, rounds, **req_kw):
    handles = []
    for rnd in rounds:
        handles += [loop.submit(make(prompt=p, max_new=m, **req_kw))
                    for p, m in rnd]
        loop.run()
    return handles


def _port_loop(tm, tp, **kw):
    kw.setdefault("lanes", 2)
    kw.setdefault("block", 4)
    kw.setdefault("chunk_prefill", C)
    return ServeLoop(tm, tp, device="cpu", **kw)


PREFIX_COUNTERS = ("prefix_lookups", "prefix_hits", "prefix_exact_hits",
                   "prefix_copies", "prefix_tokens_reused", "prefix_inserts",
                   "prefix_evictions", "chunk_dispatches",
                   "prefill_dispatches", "admit_dispatches")


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_serve_trace_equals_reference_serve_loop(kv):
    jm, jp, tm, tp = _pair("longchat-7b", kv)
    rounds = _trace(tm.cfg.vocab_size)
    jloop = JaxServeLoop(jm, jp, lanes=2, block=4, chunk_prefill=C,
                         prefix_cache_bytes=BUDGET)
    tloop = _port_loop(tm, tp, prefix_cache_bytes=BUDGET)
    jh = _drive(jloop, JaxRequest, rounds)
    th = _drive(tloop, Request, rounds)
    assert [h.tokens for h in th] == [h.tokens for h in jh]
    assert all(h.done for h in th)
    for name in PREFIX_COUNTERS:
        assert tloop.counters[name] == jloop.counters[name], name
    for a, b in zip(th, jh):
        assert (a.stats.prefix_tokens, a.stats.prefix_exact,
                a.stats.prefill_chunks) == (b.stats.prefix_tokens,
                                            b.stats.prefix_exact,
                                            b.stats.prefill_chunks), a.rid
    # what the trace implies: B at 32, G at 16, A and H exact, and with
    # bf16 KV also L from S's whole-bucket rows
    reused = [h.stats.prefix_tokens for h in th]
    assert reused == [0, 0, 0, 32, 48, 16, 12, 16 if kv == "bf16" else 0]
    assert tloop.counters["prefix_exact_hits"] == 2
    tagg, jagg = tloop.aggregate(), jloop.aggregate()
    for name in ("prefix_hit_rate", "prefix_dedup_ratio",
                 "prefix_cache_entries", "prefix_cache_bytes"):
        assert tagg[name] == pytest.approx(jagg[name]), name
    assert 0 < tagg["prefix_cache_bytes"] <= BUDGET


# ---------------------------------------------------------------------------
# the port alone, against its cold loop
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_warm_streams_equal_cold_loop(kv):
    _, _, tm, tp = _pair("longchat-7b", kv)
    rounds = _trace(tm.cfg.vocab_size)
    warm = _port_loop(tm, tp, prefix_cache_bytes=BUDGET)
    cold = _port_loop(tm, tp)
    hw, hc = _drive(warm, Request, rounds), _drive(cold, Request, rounds)
    assert [h.tokens for h in hw] == [h.tokens for h in hc]
    assert warm.counters["chunk_dispatches"] < cold.counters[
        "chunk_dispatches"]
    assert cold.prefix_cache is None and cold.counters["prefix_lookups"] == 0


def test_exact_hit_runs_no_prefill():
    _, _, tm, tp = _pair("longchat-7b", "bf16")
    prompt = _prompt(tm.cfg.vocab_size, 40, seed=6)
    loop = _port_loop(tm, tp, prefix_cache_bytes=BUDGET)
    (h1,) = _drive(loop, Request, [[(prompt, 4)]])
    before = (loop.counters["prefill_dispatches"],
              loop.counters["chunk_dispatches"])
    (h2,) = _drive(loop, Request, [[(prompt, 4)]])
    assert (loop.counters["prefill_dispatches"],
            loop.counters["chunk_dispatches"]) == before
    assert loop.counters["prefix_exact_hits"] == 1
    assert h2.stats.prefix_exact and h2.stats.prefill_chunks == 0
    assert h2.tokens == h1.tokens and len(h1.tokens) == 4
    assert loop.prefix_host_s["splice_s"] > 0


def test_whole_bucket_donor_feeds_chunked_resume():
    _, _, tm, tp = _pair("longchat-7b", "bf16")
    rng = np.random.default_rng(7)
    head = rng.integers(0, tm.cfg.vocab_size, 16)    # <= heavy: unpruned
    long = np.concatenate([head, rng.integers(0, tm.cfg.vocab_size, 48)])
    loop = _port_loop(tm, tp, prefix_cache_bytes=BUDGET)
    _drive(loop, Request, [[(head, 2)]])
    assert loop.prefix_cache.match_rows(long, cap=48).depth == 16
    (h,) = _drive(loop, Request, [[(long, 3)]])
    assert h.stats.prefix_tokens == 16 and not h.stats.prefix_exact
    assert loop.counters["chunk_dispatches"] == 3    # chunks 1..3 of 4
    (c,) = _drive(_port_loop(tm, tp), Request, [[(long, 3)]])
    assert h.tokens == c.tokens


def test_reuse_prefix_opt_out_looks_up_and_inserts_nothing():
    _, _, tm, tp = _pair("longchat-7b", "bf16")
    loop = _port_loop(tm, tp, prefix_cache_bytes=BUDGET)
    _drive(loop, Request, _trace(tm.cfg.vocab_size), reuse_prefix=False)
    assert loop.counters["prefix_lookups"] == 0
    assert loop.counters["prefix_hits"] == 0
    assert loop.prefix_cache.entries == 0 and loop.prefix_cache.bytes == 0
    assert loop.prefix_host_s == {"insert_s": 0.0, "splice_s": 0.0}


def test_small_budget_evicts_by_lru():
    """A budget that holds two finalized states of 16-token prompts: the
    third insert evicts the least recently used, and a hit refreshes."""
    _, _, tm, tp = _pair("longchat-7b", "bf16")
    prompts = [_prompt(tm.cfg.vocab_size, 12, seed=10 + i) for i in range(3)]
    one = tpc._tree_nbytes(tm.init_decode_state(1)) + 4 * tm.cfg.vocab_size
    loop = _port_loop(tm, tp, prefix_cache_bytes=2 * one + one // 2)
    _drive(loop, Request, [[(prompts[0], 2)], [(prompts[1], 2)],
                           [(prompts[0], 2)],        # hit: [1] becomes LRU
                           [(prompts[2], 2)]])
    pc = loop.prefix_cache
    assert loop.counters["prefix_exact_hits"] == 1
    assert pc.entries == 2 and pc.evictions == 1 and pc.bytes == 2 * one
    assert pc.match_state(prompts[1]) is None
    assert pc.match_state(prompts[0]) is not None
    assert pc.match_state(prompts[2]) is not None
    assert loop.aggregate()["prefix_evictions"] == 1.0


def test_exact_hit_lane_does_not_alias_trie_entry():
    """Decoding a lane spliced from a cached state leaves the entry as it
    was: the splice copies (on the CPU `.to("cpu")` would not)."""
    _, _, tm, tp = _pair("longchat-7b", "bf16")
    prompt = _prompt(tm.cfg.vocab_size, 40, seed=8)
    loop = _port_loop(tm, tp, prefix_cache_bytes=BUDGET)
    _drive(loop, Request, [[(prompt, 3)]])
    entry = loop.prefix_cache.match_state(prompt)
    saved = {f: getattr(entry.state.kv, f).clone() for f in FIELDS
             if getattr(entry.state.kv, f) is not None}
    logits = entry.logits.clone()
    (h,) = _drive(loop, Request, [[(prompt, 12)]])
    assert h.stats.prefix_exact and len(h.tokens) == 12
    assert loop.prefix_cache.match_state(prompt) is entry
    for f, want in saved.items():
        assert torch.equal(getattr(entry.state.kv, f), want), f
    assert torch.equal(entry.logits, logits)
    lane_step = loop.state.kv.step[:, h.stats.lane]
    assert int(lane_step.min()) > int(entry.state.kv.step.max())


def test_boundary_acc_snapshot_keeps_its_boundary_value():
    """acc columns keep absorbing mass from later chunks' query rows: the
    snapshot at boundary 16 must equal a prefill that stopped there, not
    the finished workspace."""
    _, _, tm, tp = _pair("longchat-7b", "bf16")
    prompt = _prompt(tm.cfg.vocab_size, 48, seed=9)
    loop = _port_loop(tm, tp, prefix_cache_bytes=BUDGET)
    _drive(loop, Request, [[(prompt, 2)]])
    entries = [loop.prefix_cache.match_rows(prompt, cap=q) for q in (16, 32,
                                                                     48)]
    assert [e.depth for e in entries] == [16, 32, 48]
    bucket = 64
    for e in entries:
        _, ps = _chunks(tm, tp, tm.init_prefill_chunk_state(1, bucket),
                        np.pad(prompt, (0, bucket - 48)), 0, e.depth // C, 48)
        assert torch.equal(e.acc, ps.acc[:, 0, :, :e.depth])
        assert torch.equal(e.k, ps.k[:, 0, :, :e.depth])
        assert torch.equal(e.v, ps.v[:, 0, :, :e.depth])
    _, full = _chunks(tm, tp, tm.init_prefill_chunk_state(1, bucket),
                      np.pad(prompt, (0, bucket - 48)), 0, 3, 48)
    assert not torch.equal(entries[0].acc, full.acc[:, 0, :, :16])


# ---------------------------------------------------------------------------
# the surgery namespace and the CLI
# ---------------------------------------------------------------------------

SURGERY_OMITTED = {"slot_window", "slot_window_merge", "decode_window",
                   "lane_shardings"}


def test_surgery_names_equal_reference_minus_omissions():
    import repro.surgery as jsurgery
    import repro_torch.surgery as surgery
    from repro_torch.models import transformer as T
    assert set(surgery.__all__) == set(jsurgery.__all__) - SURGERY_OMITTED
    for name in surgery.__all__:
        assert callable(getattr(surgery, name)), name
    for name in SURGERY_OMITTED:
        assert name in surgery.__doc__, name
    assert surgery.state_lane_insert is T.lane_insert
    assert surgery.state_lanes_insert is T.lanes_insert
    assert surgery.state_lane_select is T.lane_select
    assert surgery.kv_lane_insert is tcache.lane_insert
    assert surgery.cache_prefix_rows is tcache.cache_prefix_rows


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_state_lane_surgery_roundtrip(kv):
    """lane_slice / lane_insert / lane_select move every field of one lane
    and leave the others."""
    import repro_torch.surgery as surgery
    _, _, tm, tp = _pair("longchat-7b", kv)
    tokens = np.stack([_prompt(tm.cfg.vocab_size, 20, seed=s)
                       for s in range(3)])
    _, st = tm.prefill(tp, {"tokens": torch.as_tensor(tokens)})
    one = surgery.state_lane_slice(st, 2)
    empty = tm.init_decode_state(3)
    surgery.state_lane_insert(empty, 0, one)
    active = torch.tensor([True, False, True])
    merged = surgery.state_lane_select(active, st, empty)
    for f in FIELDS:
        a = getattr(st.kv, f)
        if a is None:
            continue
        assert torch.equal(getattr(one.kv, f)[:, 0], a[:, 2]), f
        assert torch.equal(getattr(empty.kv, f)[:, 0], a[:, 2]), f
        assert torch.equal(getattr(merged.kv, f)[:, 2], a[:, 2]), f
        assert torch.equal(getattr(merged.kv, f)[:, 1],
                           getattr(empty.kv, f)[:, 1]), f
    getattr(st.kv, "acc").add_(1)               # slices are copies
    assert not torch.equal(one.kv.acc[:, 0], st.kv.acc[:, 2])


def test_cli_prefix_cache(capsys):
    main(["--reduced", "--serve", "--batch", "2", "--prompt-len", "48",
          "--new-tokens", "4", "--chunk-prefill", "16", "--prefix-cache",
          str(BUDGET), "--device", "cpu"])
    out = capsys.readouterr().out
    line = [ln for ln in out.splitlines() if ln.startswith("prefix cache:")]
    assert len(line) == 1 and "hit_rate=" in line[0]
    assert "entries" in line[0]


def test_loop_without_chunking_never_derives_rows():
    """Rows donors ride the sliced path: without `chunk_prefill` only
    finalized states enter the trie."""
    _, _, tm, tp = _pair("longchat-7b", "bf16")
    loop = _port_loop(tm, tp, chunk_prefill=0, prefix_cache_bytes=BUDGET)
    prompt = _prompt(tm.cfg.vocab_size, 16, seed=12)
    _drive(loop, Request, [[(prompt, 2)], [(prompt, 2)]])
    assert not loop._rows_reuse
    assert loop.prefix_cache.entries == 1
    assert loop.counters["prefix_exact_hits"] == 1
    assert loop.aggregate()["prefix_hit_rate"] == 0.5
