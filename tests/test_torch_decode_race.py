"""The decode kernels' race, rehearsed on the CPU.

`ragged_decode.cu` and `fused_decode.cu` pick their winners with a radix
select (`select_topk` in `csrc/decode_common.cuh`). No CUDA kernel runs
here, so its algorithm is written once more below in torch, step for step:
the order-preserving map of an f32 onto a uint32 key (-0.0 made equal to
+0.0), four 8-bit histogram passes that find the k-th key, and the tie
rule (every slot above it, then the lowest-index slots equal to it). Its
winner sets are held exactly to `jax.lax.top_k` (the reference's
`core/topk.exact_topk`, per selection block) on rows built from a numpy
seed: many equal sums straddling the k-th value, more protected slots than
select_k, fill 0, fill below select_k, -0.0 beside +0.0, S not a multiple
of the kernels' 64-slot block, and 1, 2, 4 and 8 selection blocks.

Through the oracles, inputs whose `out` names the winner set (every K row
equal, so each valid winner weighs 1/n; V = 1 and vscale[s] = s + 1, so
out is the mean of the winners' slot numbers plus one, and one wrong
winner moves it by at least 1/select_k) hold the same select to the
reference's `fused_decode_ref`, its Pallas kernels in interpret mode, and
the port's `fused_decode_ref`."""
import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.core.topk import exact_topk  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.fused_decode import fused_decode as jax_fused  # noqa: E402
from repro.kernels.ragged_decode import ragged_decode as jax_ragged  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

NEG_INF, PROT_WIN = -1e30, 1e30
SET_ATOL = 1e-4        # f32 means of slot numbers below 1100: far below 1/k


# ---------------------------------------------------------------------------
# the kernel's select, in torch
# ---------------------------------------------------------------------------


def order_key(x: torch.Tensor) -> torch.Tensor:
    """f32 values → int64 keys in [0, 2^32): a larger float has a larger
    key, and -0.0 has +0.0's (`order_key` in the kernel)."""
    b = x.to(torch.float32).contiguous().view(torch.int32).to(torch.int64)
    b = b & 0xFFFFFFFF
    b = torch.where(b == 0x80000000, torch.zeros_like(b), b)
    neg = (b & 0x80000000) != 0
    return torch.where(neg, b ^ 0xFFFFFFFF, b | 0x80000000)


def radix_select(keys: torch.Tensor, k: int) -> torch.Tensor:
    """Slots of the k largest of the 1-D `keys` (k <= len), ties to the
    lower slot, in the kernel's order: first the slots above the k-th key
    in slot order, then the lowest-index slots equal to it."""
    prefix, mask, rem = 0, 0, k
    for shift in (24, 16, 8, 0):
        cand = keys[(keys & mask) == prefix]
        hist = torch.bincount((cand >> shift) & 255, minlength=256)
        # find_bin: the top bins first; the bin where the count reaches rem
        incl = torch.cumsum(hist.flip(0), 0)
        top = int(torch.nonzero(incl >= rem)[0])
        above = int(incl[top] - hist.flip(0)[top])
        prefix |= (255 - top) << shift
        mask |= 255 << shift
        rem -= above
    gt = torch.nonzero(keys > prefix).flatten()
    eq = torch.nonzero(keys == prefix).flatten()[:rem]
    assert len(gt) == k - rem
    return torch.cat([gt, eq])


def race(ssel: torch.Tensor, select_k: int, nb: int) -> torch.Tensor:
    """[BH, S] selection sums → [BH, select_k] winners: each of nb equal
    slot blocks picks select_k / nb by `radix_select`."""
    bh, s = ssel.shape
    bs, k_loc = s // nb, select_k // nb
    keys = order_key(ssel)
    return torch.stack([torch.cat([
        radix_select(keys[r, b * bs:(b + 1) * bs], k_loc) + b * bs
        for b in range(nb)]) for r in range(bh)])


def top_k_sets(ssel: np.ndarray, select_k: int, nb: int) -> torch.Tensor:
    """The reference's winners: lax.top_k per selection block."""
    bh, s = ssel.shape
    _, idx = exact_topk(jnp.asarray(ssel).reshape(bh, nb, s // nb),
                        select_k // nb)
    idx = np.asarray(idx) + (np.arange(nb) * (s // nb))[None, :, None]
    return torch.as_tensor(idx.reshape(bh, select_k))


def same_sets(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(torch.sort(a, dim=-1).values,
                       torch.sort(b, dim=-1).values)


# ---------------------------------------------------------------------------
# rows of selection sums, as the kernel builds them
# ---------------------------------------------------------------------------


def selection_sums(raw: np.ndarray, prot: np.ndarray) -> np.ndarray:
    """[BH, G, S] scores (NEG_INF at invalid slots) → the G-row sum in row
    order in f32, PROT_WIN at protected slots (`score_tile`)."""
    t = raw[:, 0].astype(np.float32)
    for g in range(1, raw.shape[1]):
        t = (t + raw[:, g]).astype(np.float32)
    return np.where(prot != 0, np.float32(PROT_WIN), t).astype(np.float32)


def race_rows(kind: str, s: int, g: int, select_k: int, seed: int):
    """[6, S] selection sums of one kind of row, from a numpy seed."""
    rng = np.random.default_rng(seed)
    bh = 6
    raw = rng.integers(0, 4, (bh, g, s)).astype(np.float32) * 0.25
    fills = np.full(bh, s)
    prot = np.zeros((bh, s), np.int8)
    if kind == "ties":           # few distinct sums: runs of equal values
        prot = (rng.random((bh, s)) < 0.02).astype(np.int8)
    elif kind == "protected":    # more protected slots than select_k
        prot = (rng.random((bh, s)) < 0.5).astype(np.int8)
        prot[:, :select_k + 3] = 1
    elif kind == "fill0":        # a free lane: every slot dead
        fills[:] = 0
    elif kind == "short":        # fewer valid slots than select_k
        fills = rng.integers(1, select_k, bh)
        prot = (rng.random((bh, s)) < 0.1).astype(np.int8)
    elif kind == "zeros":        # -0.0 beside +0.0 straddling the k-th
        raw = np.full((bh, g, s), -0.0, np.float32)   # x + -0.0 keeps x
        raw[:, 0] = rng.choice(np.array([-0.0, 0.0], np.float32), (bh, s))
        for r in range(bh):                           # fewer ones than k
            raw[r, 0, rng.choice(s, select_k // 3, replace=False)] = 1.0
    elif kind == "random":
        raw = rng.standard_normal((bh, g, s)).astype(np.float32)
        fills = rng.integers(0, s + 1, bh)
        prot = (rng.random((bh, s)) < 0.1).astype(np.int8)
    valid = np.arange(s)[None, :] < fills[:, None]
    raw = np.where(valid[:, None, :], raw, np.float32(NEG_INF))
    prot = prot * valid.astype(np.int8) if kind != "protected" else prot
    return selection_sums(raw, prot)


KINDS = ["ties", "protected", "fill0", "short", "zeros", "random"]


def test_order_key_preserves_the_float_order():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        rng.standard_normal(2000).astype(np.float32) * 10.0 ** rng.integers(
            -40, 38, 2000),
        np.array([0.0, -0.0, 1e30, -1e30, -2e30, -4e30, 1e-45, -1e-45,
                  np.finfo(np.float32).max, -np.finfo(np.float32).max],
                 np.float32)]).astype(np.float32)
    keys = order_key(torch.as_tensor(x)).numpy()
    assert int(keys.min()) >= 0 and int(keys.max()) < 2 ** 32
    i, j = np.triu_indices(len(x), 1)
    pick = (np.arange(len(i)) % 97 == 0) | (i >= 2000)   # every special pair
    i, j = i[pick], j[pick]
    assert np.array_equal(x[i] < x[j], keys[i] < keys[j])
    assert np.array_equal(x[i] == x[j], keys[i] == keys[j])   # -0.0 == +0.0


@pytest.mark.parametrize("nb", [1, 2, 4, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_radix_select_equals_lax_top_k(kind, nb):
    """S = 1000 (not a multiple of 64), select_k = 64, G = 2. lax.top_k
    orders +0.0 above -0.0 (XLA's total order), the kernels do not: the
    sums are compared with -0.0 made +0.0 (x + 0.0), and the sign's own
    case is `test_signed_zeros_follow_the_reference_kernels`."""
    s, select_k = 1000, 64
    ssel = race_rows(kind, s, 2, select_k, seed=KINDS.index(kind))
    got = race(torch.as_tensor(ssel), select_k, nb)
    want = top_k_sets(ssel + np.float32(0.0), select_k, nb)
    assert same_sets(got, want)
    # each block's picks lie in the block
    bs = s // nb
    blocks = got.reshape(-1, nb, select_k // nb) // bs
    assert torch.equal(blocks, torch.arange(nb)[None, :, None].expand_as(
        blocks))


@pytest.mark.parametrize("s,select_k,nb", [(1088, 128, 1), (1088, 128, 4),
                                           (576, 64, 1), (100, 8, 2)])
def test_radix_select_at_served_shapes(s, select_k, nb):
    """The served slot counts, heavy ties and a mixed row of each kind."""
    for seed, kind in enumerate(KINDS):
        ssel = race_rows(kind, s, 1, select_k, seed=100 + seed)
        got = race(torch.as_tensor(ssel), select_k, nb)
        assert same_sets(got, top_k_sets(ssel + np.float32(0.0), select_k,
                                         nb)), kind


# ---------------------------------------------------------------------------
# inputs whose out names the winner set, through the oracles and kernels
# ---------------------------------------------------------------------------


def set_inputs(bh, g, d, s, select_k, fills, prot_frac, seed, tiny=False):
    """numpy decode inputs, int8 K/V, whose out is the mean of (s + 1) over
    the valid winners: K rows all equal, V codes 1, vscale[s] = s + 1.
    Mirror codes in {0, 1} with equal mscale, so the selection sums tie in
    runs. `tiny` scales make every score underflow to -0.0 or +0.0."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g, d)).astype(np.float32)
    qq = rng.integers(-1, 2, (bh, g, d)).astype(np.int8)
    qs = np.full((bh, g), 1e-30 if tiny else 0.5, np.float32)
    mirror = (rng.random((bh, s, d)) < 0.08).astype(np.int8)
    ms = np.full((bh, s), 1e-20 if tiny else 0.25, np.float32)
    krow = rng.integers(-127, 128, (bh, 1, d)).astype(np.int8)
    k = np.repeat(krow, s, axis=1)
    v = np.ones((bh, s, d), np.int8)
    ks = np.full((bh, s), 0.01, np.float32)
    vs = np.tile(np.arange(1, s + 1, dtype=np.float32), (bh, 1))
    fills = np.asarray(fills, np.int32)
    valid = (np.arange(s)[None, :] < fills[:, None]).astype(np.int8)
    prot = (rng.random((bh, s)) < prot_frac).astype(np.int8) * valid
    prot[-1, :] = valid[-1]            # the last row: all valid slots protected
    return fills, [q, qq, qs, mirror, ms, ks, vs, valid, prot, k, v]


def expected_out(args, select_k, nb):
    """The mean of (s + 1) over the valid winners of the kernel's select,
    per row, from the selection sums the kernel builds; 0 for none."""
    q, qq, qs, mirror, ms, ks, vs, valid, prot, k, v = args
    dots = np.einsum("bgd,bsd->bgs", qq.astype(np.int64),
                     mirror.astype(np.int64)).astype(np.float32)
    raw = (dots * qs[..., None]).astype(np.float32) * ms[:, None, :]
    raw = np.where(valid[:, None, :] != 0, raw.astype(np.float32),
                   np.float32(NEG_INF))
    win = race(torch.as_tensor(selection_sums(raw, prot)), select_k,
               nb).numpy()
    ok = np.take_along_axis(valid, win, 1) != 0
    n = ok.sum(1)
    tot = np.where(ok, win + 1.0, 0.0).sum(1)
    return np.where(n > 0, tot / np.maximum(n, 1), 0.0)


def _check_out(out, want, g, d):
    out = np.asarray(out, np.float64)
    assert out.shape[1:] == (g, d)
    np.testing.assert_allclose(out, np.broadcast_to(want[:, None, None],
                                                    out.shape),
                               atol=SET_ATOL, rtol=0)


SET_CASES = [  # bh, g, d, s, select_k, nb, fills
    (6, 1, 16, 100, 16, 1, [0, 9, 57, 100, 100, 100]),
    (6, 2, 16, 96, 16, 2, [96, 0, 11, 64, 90, 96]),
    (6, 1, 32, 128, 32, 4, [128, 20, 77, 128, 3, 128]),
    (5, 2, 16, 64, 16, 8, [64, 0, 40, 7, 64]),
]


@pytest.mark.parametrize("bh,g,d,s,select_k,nb,fills", SET_CASES)
def test_oracles_pick_the_radix_select_winners(bh, g, d, s, select_k, nb,
                                               fills):
    """The reference's oracle, the port's plain version and the
    reference's Pallas kernel (interpret mode; `ragged_decode` for one
    block, `fused_decode` for more) all give the out of the select's
    winner set, row by row."""
    fl, args = set_inputs(bh, g, d, s, select_k, fills, 0.15, seed=s + nb)
    want = expected_out(args, select_k, nb)
    jargs = [jnp.asarray(a) for a in args]
    out_j, _ = jref.fused_decode_ref(*jargs, select_k=select_k,
                                     num_blocks=nb)
    _check_out(out_j, want, g, d)
    out_t, _ = ref.fused_decode_ref(*[torch.as_tensor(a) for a in args],
                                    select_k=select_k, num_blocks=nb)
    _check_out(out_t.numpy(), want, g, d)
    if nb == 1:
        out_k, _ = jax_ragged(jnp.asarray(fl), *jargs, select_k=select_k,
                              block_s=16, interpret=True)
    else:
        out_k, _ = jax_fused(*jargs, select_k=select_k, num_blocks=nb,
                             interpret=True)
    _check_out(out_k, want, g, d)


@pytest.mark.parametrize("nb", [1, 2])
def test_signed_zeros_follow_the_reference_kernels(nb):
    """Every score underflows to -0.0 or +0.0. The kernels' select takes
    them as equal (lowest slot first), as the reference's own Pallas
    kernels (`jnp.argmax` rounds) and the port's plain version (a stable
    sort) do; `lax.top_k`, and so the reference's oracle, put +0.0 first."""
    bh, g, d, s, select_k = 4, 1, 16, 64, 8
    fl, args = set_inputs(bh, g, d, s, select_k, [64, 64, 40, 64], 0.0,
                          seed=7, tiny=True)
    args[8][-1] = 0                    # no protected slot at all
    want = expected_out(args, select_k, nb)
    jargs = [jnp.asarray(a) for a in args]
    if nb == 1:
        out_k, _ = jax_ragged(jnp.asarray(fl), *jargs, select_k=select_k,
                              block_s=16, interpret=True)
    else:
        out_k, _ = jax_fused(*jargs, select_k=select_k, num_blocks=nb,
                             interpret=True)
    _check_out(out_k, want, g, d)
    out_t, _ = ref.fused_decode_ref(*[torch.as_tensor(a) for a in args],
                                    select_k=select_k, num_blocks=nb)
    _check_out(out_t.numpy(), want, g, d)
    # the oracle differs exactly where +0.0 and -0.0 straddle the k-th
    out_j, _ = jref.fused_decode_ref(*jargs, select_k=select_k,
                                     num_blocks=nb)
    assert not np.allclose(np.asarray(out_j)[:, 0, 0], want, atol=SET_ATOL)
