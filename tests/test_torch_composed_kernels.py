"""The algorithms of the composed path's two Hopper kernels, emulated on the
CPU in the kernels' own order and held to the reference.

- `gather_attention` (`csrc/gather_attention.cu`): one thread a K row
  for the logits, one warp a query row for the softmax with 1/l kept for
  the epilogue, and p·v with the warps on the columns and eight row groups
  of a warp on the rows (the staged rows, then the rest), their sums met
  in a butterfly. Held within 1e-4 to `repro.kernels.ref.gather_attention_ref`
  and, on rows with a valid slot, to `repro.kernels.ops.gather_attention`
  (the Pallas kernel in interpret mode, K padded to its block; on a row
  with no valid slot that op averages over its padding, a quirk of the
  reference: `tests/test_torch_decode_kernels.py`).
- `approx_score` (`approx_score_mma_kernel<VEC, PACKED>`, one body for
  both routes): the persistent CTAs' even shares of (row, 32-slot tile)
  items, the warps' turns and their division-free step, the m16n8k32
  fragments of PTX's layout with the lanes' 16-, 8- or 4-byte loads and
  the one permutation of k they share with the query, the zero padding of
  G to 16 and of d to the 128-code chunk, the skip of empty tiles and of
  invalid rows, and the exchange tile's epilogue. The packed route's
  loader expands each nibble word into its even and odd codes times 16
  (with the query's matching `prmt` words) and the epilogue shifts the
  sum right by 4. Held bit for bit to `repro.kernels.ops.approx_score` /
  `approx_score_packed` (interpret mode) and to the plain versions, with
  every (g, s) written exactly once.
- The launcher's shared-memory plan for `gather_attention`: whatever the
  wrapper admits (the [G][d] query and [G][K] logits fit), the launch fits.
"""
import math

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.approx_score import \
    approx_score_packed as japprox_packed  # noqa: E402
from repro_torch.core import quant  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

jax.config.update("jax_platform_name", "cpu")

WARPS = 4                 # approx_score's kWarps: 128 threads a CTA
NEG_INF = np.float32(-1e30)
SMEM_OPTIN = 232448       # what one H100 block may opt into


def _butterfly(x, lanes, offsets):
    """Each lane's x after `x += shfl_xor(x, o)` for o in offsets; x has the
    lanes on its last axis (f32 adds in the kernel's tree order)."""
    idx = np.arange(lanes)
    for o in offsets:
        x = (x + x[..., idx ^ o]).astype(np.float32)
    return x


# ---------------------------------------------------------------------------
# gather_attention
# ---------------------------------------------------------------------------


def _emulate_gather(q, k, v, valid, elt):
    """out [BH, G, dv] f32 in gather_attention_kernel's order (the WIDE
    route: rows of 16-byte multiples; `elt` the K/V element's bytes)."""
    q, k, v = (np.asarray(x, np.float32) for x in (q, k, v))
    bh, g, d = q.shape
    kk, dv = k.shape[1], v.shape[-1]
    scale = np.float32(1.0 / math.sqrt(d))
    ns = _gather_plan(kk, g, d, dv, elt)[0]     # rows in the stage
    out = np.zeros((bh, g, dv), np.float32)
    for r in range(bh):
        # 2. logits: one thread a row, its elements in order
        acc = np.zeros((g, kk), np.float32)
        for e in range(d):
            acc = (acc + q[r, :, e, None] * k[r, None, :, e]).astype(
                np.float32)
        logit = np.where(valid[r][None] != 0, acc * scale, NEG_INF).astype(
            np.float32)
        # 3. softmax: lane l holds j = l, l + 32, ...; max then sum, warp
        # butterflies; 1/l kept
        pad = (-kk) % 32
        lg = np.concatenate([logit, np.full((g, pad), -np.inf, np.float32)],
                            1).reshape(g, -1, 32)
        mx = lg.max(axis=(1, 2))
        e = np.exp((logit - mx[:, None]).astype(np.float32)).astype(
            np.float32)
        ep = np.concatenate([e, np.zeros((g, pad), np.float32)], 1).reshape(
            g, -1, 32)
        z = np.zeros((g, 32), np.float32)
        for t in range(ep.shape[1]):
            z = (z + ep[:, t]).astype(np.float32)
        z = _butterfly(z, 32, [16, 8, 4, 2, 1])[:, 0]
        inv_l = (np.float32(1) / z).astype(np.float32)
        # 4. p·v: 8 row groups walk the staged rows, then the others, 8 at
        # a time; rows every g weighs 0 count 0; the groups meet in the
        # shuffles at xor 4, 8, 16 lanes (group grp meets grp ^ 1, 2, 4)
        pv = np.zeros((g, dv, 8), np.float32)
        for lo, hi in ((0, ns), (ns, kk)):
            for j0 in range(lo, hi, 8):
                for grp in range(8):
                    j = j0 + grp
                    if j < hi and e[:, j].any():
                        pv[:, :, grp] = (pv[:, :, grp]
                                         + e[:, j, None] * v[r, j][None]
                                         ).astype(np.float32)
        tot = _butterfly(pv, 8, [1, 2, 4])[..., 0]
        out[r] = (tot * inv_l[:, None]).astype(np.float32)
    return out


def _gather_args(bh, g, d, kk, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((bh, g, d)).astype(np.float32)
    k = rng.standard_normal((bh, kk, d)).astype(np.float32)
    v = rng.standard_normal((bh, kk, d)).astype(np.float32)
    if dtype == "int8":
        q /= 127
        k = rng.integers(-127, 128, (bh, kk, d)).astype(np.int8)
        v = rng.integers(-127, 128, (bh, kk, d)).astype(np.int8)
    valid = (rng.random((bh, kk)) < 0.6).astype(np.int8)
    valid[0] = 0                         # no valid slot: the mean of V
    valid[1] = 0
    valid[1, kk // 3] = 1                # one valid slot
    valid[2] = 1                         # every slot valid
    return q, k, v, valid


# K: a warp step's multiple, a row count below it, and one above the
# 256-row staging loop; G: 1 (longchat), 4 (granite), 12 (starcoder2), 16
@pytest.mark.parametrize("g,d,kk,dtype", [
    (1, 128, 128, "bf16"), (4, 64, 40, "f32"), (12, 128, 257, "bf16"),
    (16, 112, 40, "int8"), (1, 112, 257, "int8"), (16, 64, 128, "f32"),
])
def test_gather_emulation_matches_references(g, d, kk, dtype):
    q, k, v, valid = _gather_args(4, g, d, kk, dtype, seed=kk + g)
    elt = {"f32": 4, "bf16": 2, "int8": 1}[dtype]
    if dtype == "bf16":
        tk, tv = (torch.as_tensor(x).to(torch.bfloat16) for x in (k, v))
        k, v = tk.float().numpy(), tv.float().numpy()
    else:
        tk, tv = torch.as_tensor(k), torch.as_tensor(v)
    emu = _emulate_gather(q, k, v, valid, elt)
    mine = ops.gather_attention(torch.as_tensor(q), tk, tv,
                                torch.as_tensor(valid)).numpy()
    jargs = [jnp.asarray(x, jnp.float32) for x in (q, k, v)] + [
        jnp.asarray(valid)]
    oracle = np.asarray(jref.gather_attention_ref(*jargs))
    np.testing.assert_allclose(emu, oracle, rtol=0, atol=1e-4)
    np.testing.assert_allclose(emu, mine, rtol=0, atol=1e-4)
    live = valid.any(axis=1)
    pallas = np.asarray(jops.gather_attention(*jargs))
    np.testing.assert_allclose(emu[live], pallas[live], rtol=0, atol=1e-4)
    # the row with no valid slot: the mean of its V rows; one valid slot:
    # that slot's V row
    np.testing.assert_allclose(emu[0], np.broadcast_to(
        v[0].astype(np.float32).mean(0), (g, d)), rtol=0, atol=1e-4)
    np.testing.assert_allclose(emu[1], np.broadcast_to(
        v[1, kk // 3].astype(np.float32), (g, d)), rtol=0, atol=1e-4)


def _gather_plan(kk, g, d, dv, elt, limit=SMEM_OPTIN):
    """(rows staged, launch bytes) of the launcher's plan for one row: the
    fixed query + logits + 32 bytes, then K rows (padded by 16 bytes) and V
    rows (padded by what a p·v row group reads) for as many rows as the
    rest holds."""
    fixed = 32 + 4 * (g * d + g * kk)
    krb, vrb = d * elt, dv * elt
    if krb % 16 or vrb % 16:
        return 0, fixed
    k_stride = krb + 16
    v_stride = vrb + -(-(4 * 4 * elt) // 16) * 16
    at = -(-fixed // 16) * 16
    cap = min(kk, max(0, (limit - at) // (k_stride + v_stride)))
    return cap, (at + cap * (k_stride + v_stride) if cap else fixed)


@pytest.mark.parametrize("g", [1, 4, 12, 16])
def test_gather_launch_fits_wherever_the_wrapper_admits(g):
    """The wrapper admits what the old kernel took: [G][d] + [G][K] f32 and
    32 bytes within the card's opt-in shared memory. The new plan stages
    what is left and so fits wherever that does, up to the largest K."""
    for d in (16, 40, 64, 112, 128, 256):
        kmax = (SMEM_OPTIN - 32 - 4 * g * d) // (4 * g)
        for kk in (1, 40, 128, 1000, kmax // 2, kmax - 1, kmax):
            for elt in (1, 2, 4):
                for dv in (d, 64, 512):
                    cap, smem = _gather_plan(kk, g, d, dv, elt)
                    assert smem <= SMEM_OPTIN, (g, d, kk, elt, dv)
                    assert 0 <= cap <= kk
    # the served shapes stage every row
    assert _gather_plan(128, 1, 128, 128, 2)[0] == 128
    assert _gather_plan(128, 12, 128, 128, 4)[0] == 128


# ---------------------------------------------------------------------------
# approx_score, int8 route
# ---------------------------------------------------------------------------

ITEM = 32          # kItemSlots
NB = ITEM // 8     # n-blocks an item
CHUNK = 128        # kChunk
CTAS_PER_SM = {False: 4, True: 5}   # ctas_per_sm<PACKED>()


def _word_offset(vec, m, tig):
    w = vec // 4
    return ((m // w) * 4 + tig) * vec + 4 * (m % w)


ZERO = np.zeros(4, np.int64)


def _words(buf, off, d):
    """The little-endian int8 quadruple at off (zeros at or past d)."""
    return buf[off:off + 4] if off < d else ZERO


def _prmt(q0, q1, sel):
    """__byte_perm(q0, q1, sel): byte i of the result is byte (sel >> 4i)
    & 7 of the eight bytes q0, q1."""
    both = np.concatenate([q0, q1])
    return both[[(sel >> (4 * i)) & 7 for i in range(4)]]


def _s8(word):
    """The four bytes of a u32 as s8 codes, low byte first."""
    return np.frombuffer(np.uint32(word).tobytes(), np.int8).astype(np.int64)


def _a_words(q_row, k0, d, vec, tig, packed):
    """load_a: the eight A words of one query row (None: a padding row)."""
    if q_row is None:
        return [ZERO] * 8
    if not packed:
        return [_words(q_row, k0 + _word_offset(vec, m, tig), d)
                for m in range(8)]
    out = []
    for m in range(4):                     # packed word m: codes off..+7
        off = k0 + 2 * _word_offset(vec, m, tig)
        q0, q1 = ((q_row[off:off + 4], q_row[off + 4:off + 8]) if off < d
                  else (ZERO, ZERO))
        out += [_prmt(q0, q1, 0x6420), _prmt(q0, q1, 0x7531)]
    return out


def _b_words(row, kb, rb, vec, tig, live, packed):
    """load_b: the eight B words of one slot's mirror row (rb bytes) for
    the chunk at byte kb; a packed word p becomes (p << 4) & 0xF0F0F0F0
    (its even codes) and p & 0xF0F0F0F0 (its odd ones), 16·code a byte."""
    w = vec // 4
    raw = []
    for m in range(4 if packed else 8):    # word m % w of load m // w
        off = kb + ((m // w) * 4 + tig) * vec
        raw.append(row[off + 4 * (m % w):off + 4 * (m % w) + 4]
                   if live and off < rb else ZERO)
    if not packed:
        return raw
    out = []
    for x in raw:
        p = int.from_bytes(bytes(np.uint8(v & 0xFF) for v in x), "little")
        out += [_s8((p << 4) & 0xF0F0F0F0), _s8(p & 0xF0F0F0F0)]
    return out


def _mma(c, a_regs, b_regs):
    """One m16n8k32 s8 x s8 -> s32 over the warp's registers in PTX's
    fragment layout: a_regs[lane] = 4 words of 4 codes, b_regs[lane] = 2
    words, c[lane] = 4 accumulators (all int64 numpy arrays)."""
    a = np.zeros((16, 32), np.int64)
    b = np.zeros((32, 8), np.int64)
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for ai in range(16):
            row = gid if (ai < 4 or 8 <= ai < 12) else gid + 8
            col = tig * 4 + (ai & 3) + (16 if ai >= 8 else 0)
            a[row, col] = a_regs[lane][ai // 4][ai % 4]
        for bi in range(8):
            b[tig * 4 + (bi & 3) + (16 if bi >= 4 else 0), gid] = \
                b_regs[lane][bi // 4][bi % 4]
    dmat = a @ b
    for lane in range(32):
        gid, tig = lane >> 2, lane & 3
        for ci in range(4):
            c[lane][ci] += dmat[gid if ci < 2 else gid + 8, tig * 2 + (ci & 1)]


def _emulate_approx(qq, qscale, kq, kscale, valid, vec, n_sms,
                    packed=False):
    """scores [BH, G, S] f32 as approx_score_mma_kernel<vec, packed>
    computes them on n_sms SMs, and the number of writes of each element.
    packed: kq is [BH, S, d/2] uint8 nibbles (quant.pack_int4)."""
    bh, g, d = qq.shape
    s = kq.shape[1]
    rb = d // 2 if packed else d           # bytes of a mirror row
    qq64, kq64 = qq.astype(np.int64), kq.astype(np.int64)
    out = np.zeros((bh, g, s), np.float32)
    writes = np.zeros((bh, g, s), np.int64)
    tiles = -(-s // ITEM)
    items = bh * tiles
    grid = min(CTAS_PER_SM[packed] * n_sms, -(-items // WARPS))
    for cta in range(grid):
        lo, hi = items * cta // grid, items * (cta + 1) // grid
        for warp in range(WARPS):
            row, t = divmod(lo + warp, tiles)
            for n in range(len(range(lo + warp, hi, WARPS))):
                if n:                   # the kernel's step: no division
                    t += WARPS
                    while t >= tiles:
                        t, row = t - tiles, row + 1
                s0 = t * ITEM
                ok = [s0 + ln < s and valid[row, s0 + ln] != 0
                      for ln in range(ITEM)]
                if not any(ok):                    # no mirror byte read
                    for ln in range(32):
                        for gg in range(ln >> 3, g, 4):
                            for i in range(4):
                                se = s0 + 4 * (ln & 7) + i
                                if se < s:
                                    out[row, gg, se] = NEG_INF
                                    writes[row, gg, se] += 1
                    continue
                acc = [[np.zeros(4, np.int64) for _ in range(32)]
                       for _ in range(NB)]
                for kc in range(-(-d // CHUNK)):
                    k0 = kc * CHUNK
                    kb = k0 // 2 if packed else k0
                    a_w, b_w = [], []
                    for ln in range(32):
                        gid, tig = ln >> 2, ln & 3
                        a_w.append(tuple(
                            _a_words(qq64[row, r] if r < g else None, k0, d,
                                     vec, tig, packed)
                            for r in (gid, gid + 8)))
                        b_w.append([_b_words(   # a slot past S: not live
                            kq64[row, min(s0 + nb * 8 + gid, s - 1)], kb, rb,
                            vec, tig, ok[nb * 8 + gid], packed)
                            for nb in range(NB)])
                    for nb in range(NB):
                        for ks in range(4):
                            a_regs = [[a_w[ln][0][2 * ks], a_w[ln][1][2 * ks],
                                       a_w[ln][0][2 * ks + 1],
                                       a_w[ln][1][2 * ks + 1]]
                                      for ln in range(32)]
                            b_regs = [[b_w[ln][nb][2 * ks],
                                       b_w[ln][nb][2 * ks + 1]]
                                      for ln in range(32)]
                            _mma(acc[nb], a_regs, b_regs)
                tile = np.zeros((16, ITEM), np.int64)
                for ln in range(32):
                    gid, tig = ln >> 2, ln & 3
                    for nb in range(NB):
                        c = nb * 8 + 2 * tig
                        if gid < g:
                            tile[gid, c:c + 2] = acc[nb][ln][0:2]
                        if gid + 8 < g:
                            tile[gid + 8, c:c + 2] = acc[nb][ln][2:4]
                for ln in range(32):
                    q4 = ln & 7
                    for gg in range(ln >> 3, g, 4):
                        for i in range(4):
                            se = s0 + 4 * q4 + i
                            if se >= s:
                                continue
                            if ok[4 * q4 + i]:
                                v = tile[gg, 4 * q4 + i]
                                x = np.float32(v >> 4 if packed else v)
                                x = np.float32(x * qscale[row, gg])
                                out[row, gg, se] = np.float32(
                                    x * kscale[row, se])
                            else:
                                out[row, gg, se] = NEG_INF
                            writes[row, gg, se] += 1
    return out, writes


def _score_args(bh, g, d, s, seed):
    rng = np.random.default_rng(seed)
    qq = rng.integers(-127, 128, (bh, g, d)).astype(np.int8)
    qs = (rng.random((bh, g)) + 0.01).astype(np.float32)
    kq = rng.integers(-128, 128, (bh, s, d)).astype(np.int8)
    ks = (rng.random((bh, s)) + 0.01).astype(np.float32)
    valid = (rng.random((bh, s)) < 0.7).astype(np.int8)
    if s > 64:
        valid[:, 32:64] = 0               # a tile with no valid slot
    valid[-1] = 0                         # a row with none
    return qq, qs, kq, ks, valid


# S no multiple of the 32-slot item; d = 112 and 40 pad the last k-step;
# G = 1 pads 15 rows, G = 16 none; 1-2 SMs make CTAs walk several items,
# and at S = 200 on 1 SM warps step to a second item across rows
@pytest.mark.parametrize("bh,g,d,s,vec,n_sms", [
    (3, 1, 128, 77, 16, 132), (3, 4, 64, 100, 16, 1),
    (2, 16, 112, 70, 16, 132), (3, 3, 40, 45, 8, 2),
    (2, 12, 128, 33, 4, 1), (2, 2, 256, 40, 16, 132),
    (4, 2, 64, 200, 16, 1),
])
def test_approx_emulation_equals_reference_bitwise(bh, g, d, s, vec, n_sms):
    args = _score_args(bh, g, d, s, seed=s * g + d)
    emu, writes = _emulate_approx(*args, vec=vec, n_sms=n_sms)
    assert (writes == 1).all()
    want = np.asarray(jops.approx_score(*map(jnp.asarray, args)))
    np.testing.assert_array_equal(emu, want)
    np.testing.assert_array_equal(
        emu, ops.approx_score(*map(torch.as_tensor, args)).numpy())
    np.testing.assert_array_equal(emu, ref.approx_score_ref(
        *map(torch.as_tensor, args)).numpy())


def test_approx_k_permutation_covers_every_byte_once():
    """Over the four lanes of a slot and their eight words, the offsets of
    every load width tile the 128-byte chunk once, so A and B see one
    permutation of k."""
    for vec in (16, 8, 4):
        offs = sorted(_word_offset(vec, m, tig)
                      for tig in range(4) for m in range(8))
        assert offs == list(range(0, CHUNK, 4)), vec


# ---------------------------------------------------------------------------
# approx_score, packed route: the same body with the nibble loader
# ---------------------------------------------------------------------------


def _packed_args(bh, g, d, s, seed):
    """_score_args with int4 codes over the full [-8, 7], -8 and 7 in both
    nibble positions of a byte, and queries at -128 and 127; kq packed."""
    qq, qs, _, ks, valid = _score_args(bh, g, d, s, seed)
    rng = np.random.default_rng(seed + 1)
    codes = rng.integers(-8, 8, (bh, s, d)).astype(np.int8)
    codes[:, 0, 0::2], codes[:, 0, 1::2] = -8, 7
    codes[:, 1, 0::2], codes[:, 1, 1::2] = 7, -8
    valid[:, :2] = 1
    qq[:, :, 0], qq[:, :, 1] = -128, 127
    packed = quant.pack_int4(torch.as_tensor(codes)).numpy()
    return qq, qs, packed, ks, valid


# the launcher's load widths: 16 bytes where the d/2-byte row and the
# pointer allow (d = 128, 64, 256), 8 at d = 112 and on a mirror 8- but not
# 16-byte aligned, 4 at d = 40 and on one only 4-byte aligned
@pytest.mark.parametrize("bh,g,d,s,vec,n_sms", [
    (3, 1, 128, 77, 16, 132), (3, 4, 64, 100, 16, 1),
    (2, 16, 112, 70, 8, 132), (3, 3, 40, 45, 4, 2),
    (2, 12, 128, 33, 8, 1), (2, 12, 128, 70, 4, 2),
    (2, 2, 256, 40, 16, 132), (4, 2, 64, 200, 16, 1),
])
def test_approx_packed_emulation_equals_reference_bitwise(bh, g, d, s, vec,
                                                          n_sms):
    args = _packed_args(bh, g, d, s, seed=s * g + d)
    emu, writes = _emulate_approx(*args, vec=vec, n_sms=n_sms, packed=True)
    assert (writes == 1).all()
    want = np.asarray(japprox_packed(*map(jnp.asarray, args),
                                     interpret=True))
    np.testing.assert_array_equal(emu, want)
    np.testing.assert_array_equal(emu, np.asarray(
        jref.approx_score_packed_ref(*map(jnp.asarray, args))))
    np.testing.assert_array_equal(emu, ref.approx_score_packed_ref(
        *map(torch.as_tensor, args)).numpy())


@pytest.mark.parametrize("vec", [16, 8, 4])
def test_approx_packed_k_order_covers_every_code_once(vec):
    """The packed route's k order: over the four lanes of a slot, load_a's
    eight A words hold every code position of a 128-code chunk once, and
    load_b puts each mirror code, as 16·code, at the same (lane, word,
    byte) as its query code."""
    pos = np.arange(CHUNK)
    at = {}
    for tig in range(4):
        for m, word in enumerate(_a_words(pos, 0, CHUNK, vec, tig, True)):
            for byte, p in enumerate(word):
                at[(tig, m, byte)] = p
    assert sorted(at.values()) == list(range(CHUNK))
    for p in range(CHUNK):
        code = (-8, 7, -1, 1)[p % 4]
        codes = np.zeros(CHUNK, np.int8)
        codes[p] = code
        row = quant.pack_int4(torch.as_tensor(codes)).numpy().astype(
            np.int64)
        hits = {(tig, m, byte): v for tig in range(4)
                for m, word in enumerate(
                    _b_words(row, 0, CHUNK // 2, vec, tig, True, True))
                for byte, v in enumerate(word) if v}
        assert hits == {k: 16 * code for k, q in at.items() if q == p}, p
