"""The decode kernels' sharded route, stage by stage, over n simulated slot
blocks in one process, against the unsharded decode.

`kernels/ops.sharded_decode` runs, on one rank's block of a cache whose
slots are split over ranks, the score stage, the race (the global race's
candidates, or the blocked race's final winners), the gathered
candidates' race (`merge`), the attention's partials over the winners the
block holds, and probs from the row's merged softmax statistics, with
collectives between them. Here the n blocks run in turn and the
collectives are done by hand (stack, max, rescaled sums), so the plain
stages (`ref.ShardStagesRef`) are held with no process group to the
unsharded plain `ragged_decode` / `fused_decode` (`ops.fused_decode` on
CPU tensors): winner sets exact (the global race's tie rule, the lower
global slot, and -0.0 beside +0.0 included), out within 1e-5, probs at
their own scale (`probs_at_scale`: within 1e-4 of |p| + G / live,
row sums within 1e-5). Shapes: S 64 over 4 blocks, S 1,088 over 4 (a
local S of 272) and over 2, one block holding every winner. The card
tests (marked `gpu`) hold the kernels' stages (`ragged_decode.
ShardStages`) to the unsharded kernels and to the plain stages the same
way, on inputs whose out names the winner set.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import topk
from repro_torch.core.cache import SlotShard
from repro_torch.kernels import ops, ref

OUT_ATOL = 1e-5
PROBS_RTOL, PROBS_SUM_RTOL = 1e-4, 1e-5


def make_inputs(bh, g, d, s, fills, quantized, seed, hot_block=None,
                n=1):
    """Torch inputs of the decode kernels with the cache's discipline
    (slots at or past a row's fill invalid), dyadic scales so that sums of
    scores are exact and ties frequent, protected slots here and there.
    `hot_block` (with `n` blocks) makes every valid slot of that block
    score above every other block's."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g, d)).astype(np.float32)
    qq = rng.integers(-7, 8, (bh, g, d)).astype(np.int8)
    qs = ((1 + rng.integers(0, 16, (bh, g)) / 16) / 4).astype(np.float32)
    mirror = rng.integers(-3, 4, (bh, s, d)).astype(np.int8)
    ms = ((1 + rng.integers(0, 16, (bh, s)) / 16) / 8).astype(np.float32)
    if quantized:
        k = rng.integers(-127, 128, (bh, s, d)).astype(np.int8)
        v = rng.integers(-127, 128, (bh, s, d)).astype(np.int8)
        ks = (rng.random((bh, s)) * 0.02 + 0.001).astype(np.float32)
        vs = (rng.random((bh, s)) * 0.02 + 0.001).astype(np.float32)
    else:
        k = rng.standard_normal((bh, s, d)).astype(np.float32)
        v = rng.standard_normal((bh, s, d)).astype(np.float32)
        ks = np.ones((bh, s), np.float32)
        vs = ks
    fills = np.asarray(fills, np.int32)
    valid = (np.arange(s)[None, :] < fills[:, None]).astype(np.int8)
    prot = (rng.random((bh, s)) < 0.05).astype(np.int8) * valid
    if hot_block is not None:        # the other blocks score 0
        w = s // n
        mirror[:] = 0
        sgn = np.sign(qq.astype(np.int32).sum(1)).astype(np.int8)
        mirror[:, hot_block * w:(hot_block + 1) * w] = 3 * sgn[:, None, :]
        qs[:] = 0.25
        prot[:] = 0
    args = [torch.as_tensor(a) for a in (q, qq, qs, mirror, ms, ks, vs,
                                         valid, prot, k, v)]
    return torch.as_tensor(fills), args


def split(args, n):
    """The n slot blocks of the eleven inputs (q, qq and qscale whole)."""
    s = args[3].shape[1]
    w = s // n
    return [args[:3] + [a[:, i * w:(i + 1) * w].contiguous()
                        for a in args[3:]] for i in range(n)]


def simulate(make, blocks, select_k, nb):
    """The sharded route over the blocks in one process, the collectives
    by hand: `make(i, block args, offset)` builds block i's stages.
    → (out [BH,G,dv], probs [BH,S], the global winners [BH,select_k] or,
    for the blocked race, None)."""
    n = len(blocks)
    w = blocks[0][3].shape[1]
    st = [make(i, b, i * w) for i, b in enumerate(blocks)]
    winners = None
    if nb == 1:
        for x in st:
            x.race(select_k, final=False)
        gathered = torch.stack([x.candidates() for x in st])
        for x in st:
            x.merge(gathered, select_k)
            x.attend()
        winners = st[0].winners()
    else:
        for x in st:
            x.race(select_k // n, final=True)
    mz = torch.stack([x.mz() for x in st]).double()            # [n,BH,G,2]
    top = mz[..., 0].amax(dim=0)
    z = torch.where(mz[..., 0] > -np.inf, mz[..., 1] * torch.exp(
        mz[..., 0] - top), torch.zeros_like(top)).sum(dim=0)
    both = torch.stack([top, z], dim=-1).float()
    for x in st:
        x.set_mz(both.to(x.mz().device))
    probs = torch.cat([x.probs() for x in st], dim=1)
    parts = [x.partials() for x in st]
    num = torch.stack([p[0] for p in parts]).double()
    mx = torch.stack([p[1] for p in parts]).double()
    den = torch.stack([p[2] for p in parts]).double()
    m = mx.amax(dim=0)
    wgt = torch.where(mx > -np.inf, torch.exp(mx - m), torch.zeros_like(mx))
    nd = (num * wgt[..., None]).sum(0)
    dd = (den * wgt).sum(0)
    out = torch.where((m > -np.inf)[..., None], nd / dd.clamp(min=1e-30)[
        ..., None], torch.zeros_like(nd)).float()
    return out, probs, winners


def plain_stages(i, b, offset):
    return ref.ShardStagesRef(*b, offset=offset)


def probs_at_scale(probs, want, live, g):
    """(worst |probs - want| / (|want| + G / live of its row), worst
    |row sum - G| / G, the sum wanted 0 for a row with no live slot)."""
    p, pr = probs.double(), want.double()
    n = live.sum(-1, keepdim=True).double()
    err = float(((p - pr).abs() / (pr.abs() + g / n.clamp(min=1))).max())
    sums = (n[:, 0] > 0).double() * g
    return err, float((p.sum(-1) - sums).abs().max()) / g


def assert_route(got, want, fills, g, winners=None, want_winners=None):
    out, probs, _ = got
    out_w, probs_w = want
    assert float((out - out_w).abs().max()) <= OUT_ATOL
    s = probs.shape[1]
    live = torch.arange(s)[None, :] < fills[:, None]
    assert not probs[~live].any()
    err, err_sum = probs_at_scale(probs, probs_w, live, g)
    assert err <= PROBS_RTOL and err_sum <= PROBS_SUM_RTOL, (err, err_sum)
    if want_winners is not None:
        assert torch.equal(torch.sort(winners, -1).values,
                           torch.sort(want_winners, -1).values)


CASES = [
    # bh, g, d, s, n, select_k, fills, quantized
    (4, 2, 32, 64, 4, 16, [5, 30, 64, 0], False),    # < k, ragged, full, free
    (4, 2, 32, 64, 4, 16, [64, 0, 11, 47], True),
    (3, 4, 64, 1088, 4, 128, [1088, 700, 100], False),   # local S 272
    (3, 4, 64, 1088, 4, 128, [1088, 1000, 129], True),
    (2, 1, 32, 1088, 2, 128, [1088, 640], True),
]


@pytest.mark.parametrize("bh,g,d,s,n,k,fills,quantized", CASES)
def test_plain_global_race_over_blocks_equals_unsharded(bh, g, d, s, n, k,
                                                        fills, quantized):
    fills, args = make_inputs(bh, g, d, s, fills, quantized, seed=s + n)
    want = ops.fused_decode(*args, select_k=k, num_blocks=1, fills=fills)
    _, want_idx = ref.decode_race(*args[1:5], args[7], args[8], select_k=k)
    got = simulate(plain_stages, split(args, n), k, 1)
    assert_route(got, want, fills, g, got[2], want_idx)


@pytest.mark.parametrize("bh,g,d,s,n,k,fills,quantized", CASES)
def test_plain_blocked_race_one_block_a_rank_equals_unsharded(
        bh, g, d, s, n, k, fills, quantized):
    fills, args = make_inputs(bh, g, d, s, fills, quantized, seed=s - n)
    want = ops.fused_decode(*args, select_k=k, num_blocks=n)
    got = simulate(plain_stages, split(args, n), k, n)
    assert_route(got, want, fills, g)


@pytest.mark.parametrize("hot", [0, 2])
def test_plain_global_race_with_every_winner_in_one_block(hot):
    """Every valid slot of block `hot` outscores every other block's: the
    other blocks' candidates all lose, and the winner set is that block's
    top select_k."""
    bh, g, d, s, n, k = 2, 2, 32, 1088, 4, 128
    fills, args = make_inputs(bh, g, d, s, [1088, 1088], True, seed=3,
                              hot_block=hot, n=n)
    want = ops.fused_decode(*args, select_k=k, num_blocks=1, fills=fills)
    _, want_idx = ref.decode_race(*args[1:5], args[7], args[8], select_k=k)
    got = simulate(plain_stages, split(args, n), k, 1)
    assert_route(got, want, fills, g, got[2], want_idx)
    w = s // n
    assert bool(((got[2] >= hot * w) & (got[2] < (hot + 1) * w)).all())


@pytest.mark.parametrize("kind", ["ties", "zeros"])
def test_merged_candidates_are_the_whole_top_k(kind):
    """`topk.merge_candidates` over every block's `block_candidates` gives
    `exact_topk`'s set over the whole axis: on a few distinct values (ties
    everywhere, the lower global slot wins) and on -0.0 beside +0.0 (equal
    keys, as the kernels' `order_key` makes them)."""
    rng = np.random.default_rng(7)
    s, n, k = 96, 4, 24
    if kind == "ties":
        x = rng.integers(0, 5, (3, s)).astype(np.float32)
    else:
        x = rng.choice(np.array([-0.0, 0.0, 1.0, -1.0], np.float32), (3, s))
    x = torch.as_tensor(x)
    _, want = topk.exact_topk(x, k)
    w = s // n
    cands = torch.stack([topk.block_candidates(x[:, i * w:(i + 1) * w], k,
                                               i * w) for i in range(n)])
    got = topk.merge_candidates(cands, k)
    assert torch.equal(torch.sort(got, -1).values,
                       torch.sort(want, -1).values)


def test_sharded_decode_refuses_another_block_count():
    fills, args = make_inputs(2, 1, 32, 64, [64, 64], False, seed=1)

    shard = SlotShard(group=None, offset=0, total=64)
    with pytest.raises(ValueError):
        ops.sharded_decode(*split(args, 4)[0], select_k=16, num_blocks=2,
                           shard=shard, fills=fills)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


def _needs_card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")


def bits_inputs(bh, g, d, s, fills, quantized, seed):
    """`make_inputs` on the card with every lane's K rows equal and V[s][c]
    = bit c of s (vscale 1): out[c] is the share of valid winners with bit
    c set, so one wrong winner moves it by at least 1/n."""
    fills, args = make_inputs(bh, g, d, s, fills, quantized, seed)
    args[9] = args[9][:, :1].expand_as(args[9]).contiguous()
    bits = (torch.arange(s)[:, None] >> torch.arange(d)[None, :]) & 1
    args[10] = bits.to(args[10].dtype).expand(bh, s, d).contiguous()
    args[6] = torch.ones((bh, s))
    if not quantized:
        args[0], args[9], args[10] = (args[i].to(torch.bfloat16)
                                      for i in (0, 9, 10))
    return fills.cuda(), [a.cuda() for a in args]


CARD_CASES = [
    # bh, g, d, s, n, select_k, fills, quantized
    (128, 1, 128, 1088, 4, 128, None, False),   # longchat-7b's served layer
    (128, 1, 128, 1088, 4, 128, None, True),
    (4, 4, 64, 524288, 2, 2048, [524224, 400000, 2048, 0], True),
]


@pytest.mark.gpu
@pytest.mark.parametrize("nb_is_n", [False, True], ids=["global", "blocked"])
@pytest.mark.parametrize("bh,g,d,s,n,k,fills,quantized", CARD_CASES)
def test_sharded_route_kernels_match_unsharded_on_card(bh, g, d, s, n, k,
                                                       fills, quantized,
                                                       nb_is_n):
    _needs_card()
    from repro_torch.kernels import fused_decode as fused_mod
    from repro_torch.kernels import ragged_decode as ragged_mod
    if fills is None:
        fills = [1040, 1030, 1050, 690] * (bh // 4)
    fills, args = bits_inputs(bh, g, d, s, fills, quantized, seed=5)
    nb = n if nb_is_n else 1
    name = "fused_decode" if nb_is_n else "ragged_decode"
    mod = fused_mod if nb_is_n else ragged_mod

    def card(i, b, offset):
        return ragged_mod.ShardStages(
            name, mod.LAUNCHES, None if nb_is_n else fills, *b, select_k=k,
            offset=offset)
    before = mod.LAUNCHES[f"{name}_shard"]
    got = simulate(card, split(args, n), k, nb)
    torch.cuda.synchronize()
    assert mod.LAUNCHES[f"{name}_shard"] == before + n
    want = ops.fused_decode(*args, select_k=k, num_blocks=nb,
                            fills=None if nb_is_n else fills)
    if not nb_is_n:                  # the global race's winner set
        _, want_idx = ref.decode_race(*args[1:5], args[7], args[8],
                                      select_k=k)
        assert torch.equal(torch.sort(got[2], -1).values,
                           torch.sort(want_idx, -1).values)
    plain = simulate(plain_stages, split([a.cpu() for a in args], n), k, nb)
    for other in (want, plain[:2]):
        assert float((got[0] - other[0].to(got[0].device)).abs().max()) \
            <= OUT_ATOL
    assert_route(tuple(x.cpu() if x is not None else None for x in got),
                 tuple(x.cpu() for x in want), fills.cpu(), g)
