"""Rules of the port: it imports nothing of JAX or of the reference
package, its entry points never fall back to the CPU, a CPU tensor takes
the plain path without touching any kernel's launch count, and (on a card)
each kernel agrees with its plain version."""
import ast
import itertools
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_config, reduced
from repro_torch.core import baselines
from repro_torch.core import quant
from repro_torch.kernels import approx_score as approx_mod
from repro_torch.kernels import flash_prefill as flash_mod
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import gather_attention as gather_mod
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import ragged_decode as ragged_mod
from repro_torch.kernels.ragged_decode import LAUNCHES, granule, ragged_decode
from repro_torch.launch.serve import ServeLoop, greedy_generate
from repro_torch.models.transformer import Model

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imports(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), (path, mod)


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = reduced(get_config("longchat-7b"))
    prune = baselines.unicaim(heavy=24, reserve=8, select_k=8)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg, prune)
    model = Model(cfg, prune, device="cpu")
    params = model.init(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServeLoop(model, params, lanes=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        greedy_generate(model, params, {"tokens": torch.zeros(1, 4,
                                                              dtype=torch.long)},
                        2)


def _kernel_args(bh, g, d, s, fills, kv_dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    fills = torch.as_tensor(fills, dtype=torch.int32)
    valid = (torch.arange(s)[None, :] < fills[:, None]).to(torch.int8)
    prot = (torch.rand((bh, s), generator=gen) < 0.1).to(torch.int8) * valid

    def codes(*shape, hi=8):
        return torch.randint(-hi + 1, hi, shape, generator=gen,
                             dtype=torch.int8)

    if kv_dtype == torch.int8:
        k, v = codes(bh, s, d, hi=128), codes(bh, s, d, hi=128)
        ks = torch.rand((bh, s), generator=gen) * 0.02 + 0.001
        vs = torch.rand((bh, s), generator=gen) * 0.02 + 0.001
    else:
        k = torch.randn((bh, s, d), generator=gen).to(kv_dtype)
        v = torch.randn((bh, s, d), generator=gen).to(kv_dtype)
        ks = vs = torch.ones((bh, s))
    args = [torch.randn((bh, g, d), generator=gen), codes(bh, g, d),
            torch.rand((bh, g), generator=gen) + 0.05, codes(bh, s, d),
            torch.rand((bh, s), generator=gen) + 0.05, ks, vs, valid, prot,
            k, v]
    return fills.to(device), [a.to(device) for a in args]


def _set_args(bh, g, d, s, fills, kv_dtype, device, seed=0):
    """Decode inputs whose out names the winner set: every K row of a lane
    equal (each valid winner weighs 1/n), V = 1 and vscale[s] = s + 1, so
    out is the mean of the winners' s + 1 and one wrong winner moves it by
    at least 1/select_k. Mirror codes in {0, 1}, query codes in {-1, 0, 1}
    and equal scales tie the selection sums in runs; ~15% of live slots
    protected, and every valid slot of the last two rows."""
    gen = torch.Generator().manual_seed(seed)
    fills = torch.as_tensor(fills, dtype=torch.int32)
    valid = (torch.arange(s)[None, :] < fills[:, None]).to(torch.int8)
    prot = (torch.rand((bh, s), generator=gen) < 0.15).to(torch.int8) * valid
    prot[-2:] = valid[-2:]
    if kv_dtype == torch.int8:
        krow = torch.randint(-127, 128, (bh, 1, d), generator=gen,
                             dtype=torch.int8)
        ks = torch.full((bh, s), 0.01)
    else:
        krow = torch.randn((bh, 1, d), generator=gen).to(kv_dtype)
        ks = torch.ones((bh, s))
    args = [torch.randn((bh, g, d), generator=gen),
            torch.randint(-1, 2, (bh, g, d), generator=gen, dtype=torch.int8),
            torch.full((bh, g), 0.5),
            (torch.rand((bh, s, d), generator=gen) < 0.08).to(torch.int8),
            torch.full((bh, s), 0.25), ks,
            (torch.arange(s, dtype=torch.float32) + 1).expand(bh, s),
            valid, prot, krow.expand(bh, s, d),
            torch.ones((bh, s, d), dtype=kv_dtype)]
    return fills.to(device), [a.contiguous().to(device) for a in args]


def test_set_inputs_name_the_winner_set():
    """On the CPU, the plain version's out on `_set_args` inputs is the
    mean of (s + 1) over its valid winners in every row and group row."""
    bh, g, d, s, k = 6, 2, 16, 96, 16
    fills, args = _set_args(bh, g, d, s, [0, 5, 40, 96, 96, 96],
                            torch.int8, "cpu")
    out, _ = ref.fused_decode_ref(*args, select_k=k)
    assert not out[0].any()                            # fill 0
    torch.testing.assert_close(out[1], torch.full((g, d), 3.0), rtol=0,
                               atol=1e-5)              # all 5 valid slots
    prot = args[8]
    assert int(prot[-1].sum()) > k                     # more than select_k
    torch.testing.assert_close(out[-1], torch.full((g, d), (k + 1) / 2),
                               rtol=0, atol=1e-5)      # the first k of them
    assert torch.equal(out[..., :1].expand_as(out), out)


@pytest.mark.parametrize("nbytes,width", [(256, 16), (40, 8), (20, 4),
                                          (6, 1), (512, 16),
                                          # zamba2-7b, d = 112: bf16, int8
                                          (224, 16), (112, 16)])
def test_decode_kernels_copy_rows_at_their_widest_granule(nbytes, width):
    assert granule(nbytes) == width


# The decode kernels' single-CTA route: its shared-memory layout (`layout`
# in csrc/decode_common.cuh), transcribed: the bytes one CTA of
# ragged_decode (nb = 1) or fused_decode (nb selection blocks) asks for.
# The wrappers ask the kernels' own query (`ragged_decode.long_route`);
# the card tests below hold that query to this transcription. The long
# route's two kernels (csrc/decode_long.cuh) are transcribed here too.
SMEM_OPTIN, RING_BYTES, RING_STAGES, CTA_THREADS, CTA_WARPS = (
    232448, 96 * 1024, 3, 256, 8)
MAX_G = 16
LONG_RING, CHUNK_MAX, CHUNK_WORDS, LONG_CAP = 48 * 1024, 2048, 8192, 128


def _decode_smem_bytes(s, g, d, dv, k, elt, nb=1):
    at = 0
    for n in (4 * g * s, 4 * s, s, s, 4 * g * d, g * d, 4 * g, 4 * k, 4 * k,
              4 * k, 4 * k, 4 * g * k, 4 * CTA_THREADS,
              1024 * min(nb, CTA_WARPS), 8 * CTA_WARPS, 8 * CTA_WARPS,
              4 * CTA_WARPS, 16, 8 * (RING_STAGES + 2)):
        at = (at + n + 15) & ~15
    pair = ((d * elt + 15) & ~15) + ((dv * elt + 15) & ~15) + 32
    room = max(SMEM_OPTIN - at, 0)
    cap = min(max(room // pair, 1), k)
    ts = min(max(min(room, RING_BYTES) // (RING_STAGES * d), 1), CTA_THREADS)
    return at + max(RING_STAGES * ts * d, cap * pair)


def _route(s, g, d, k, elt, nb=1):
    """The route the layout says: "short" where one CTA's bytes fit the
    card's opt-in, else "long"."""
    fits = _decode_smem_bytes(s, g, d, d, k, elt, nb) <= SMEM_OPTIN
    return "short" if fits else "long"


def _take(sizes):
    at = 0
    for n in sizes:
        at = (at + n + 15) & ~15
    return at


def _long_smem_bytes(s, g, d, dv, k, elt, nb=1):
    """(score kernel, race kernel) bytes of one CTA of the long route at
    these shapes: `score_layout` and `race_layout` of decode_long.cuh,
    which take no S, select_k or nb."""
    ch = CHUNK_MAX
    while ch > 256 and ch * g > CHUNK_WORDS:
        ch >>= 1
    at = _take((4 * g * ch, 4 * ch, ch, ch, g * d, 4 * g, 4 * 2 * 256,
                4 * CTA_WARPS, 8 * RING_STAGES))
    ts = min(max(LONG_RING // (RING_STAGES * d), 1), CTA_THREADS)
    score = at + RING_STAGES * ts * d
    at = _take((4 * 2 * 256, 4 * 256, 16, 8 * CTA_WARPS, 4 * CTA_WARPS, 16,
                16, 4 * 3 * MAX_G, 4 * g * dv, 4 * g * d, 4 * LONG_CAP,
                4 * LONG_CAP, 4 * LONG_CAP, 4 * g * LONG_CAP,
                4 * CTA_THREADS, 16))
    pair = ((d * elt + 15) & ~15) + ((dv * elt + 15) & ~15) + 32
    cap = min(max((SMEM_OPTIN - at) // pair, 1), LONG_CAP)
    return score, at + cap * pair


def _largest_s(g, d, k, elt, nb=1):
    lo, hi = 1, 1 << 16
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if _decode_smem_bytes(mid, g, d, d, k, elt, nb) <= SMEM_OPTIN:
            lo = mid
        else:
            hi = mid - 1
    return lo


@pytest.mark.parametrize("g,d,s,nb", [
    (1, 128, 1088, 1), (1, 128, 1088, 4),      # longchat-7b, served
    (4, 64, 8256, 1), (4, 64, 8256, 4),        # granite: 16K prompt, heavy 8K
    (1, 128, 16384, 1), (1, 128, 22528, 1),
    (12, 128, 1088, 1), (12, 128, 1088, 4),    # starcoder2-3b, served
    (6, 128, 1088, 1),                         # grok-1-314b, served
    (1, 112, 1088, 1), (1, 112, 1088, 4),      # zamba2-7b, served
])
def test_decode_shapes_fit_in_shared_memory(g, d, s, nb):
    for elt in (4, 2, 1):
        assert _decode_smem_bytes(s, g, d, d, 128, elt, nb) <= SMEM_OPTIN


@pytest.mark.parametrize("g,d,nb,want", [
    # served decode shapes (S = 1088, select_k = 128): the layout as it was
    # before the long route (bf16 and int8 K/V alike: the ring dominates)
    (1, 128, 1, 114672), (1, 128, 4, 117744),  # longchat-7b
    (4, 64, 1, 80752), (4, 64, 4, 83824),      # granite-like GQA
    (12, 128, 1, 175248), (12, 128, 4, 178320),  # starcoder2-3b
    (6, 128, 1, 142208),                       # grok-1-314b
    (1, 112, 1, 102304), (1, 112, 4, 105376),  # zamba2-7b
    (1, 64, 1, 65200), (1, 64, 4, 68272)])     # whisper-base
def test_short_route_layout_at_served_shapes_is_unchanged(g, d, nb, want):
    for elt in (2, 1):
        assert _decode_smem_bytes(1088, g, d, d, 128, elt, nb) == want
        assert _route(1088, g, d, 128, elt, nb) == "short"


# the largest S one CTA of the single-CTA route takes at select_k = 128
# with bf16 K/V (the old slot caps)
SHORT_TOPS = [
    (1, 128, 1, 22640), (1, 128, 4, 22332), (4, 64, 1, 10204),
    (4, 64, 4, 10064), (12, 128, 1, 3957), (12, 128, 4, 3900),
    (6, 128, 1, 7354), (1, 112, 1, 22656), (1, 112, 4, 22348)]


@pytest.mark.parametrize("g,d,nb,top", SHORT_TOPS)
def test_short_route_layout_fits_exactly_up_to_its_largest_slot_count(
        g, d, nb, top):
    """The layout says "short" up to `top` slots and "long" from one slot
    past it, and "long" at decode_32k; the card test
    `test_wrapper_takes_the_short_route_exactly_where_it_fits_on_card`
    holds the wrappers' choice to it."""
    assert _largest_s(g, d, 128, 2, nb) == top
    assert _route(top, g, d, 128, 2, nb) == "short"
    assert _route(top + 1, g, d, 128, 2, nb) == "long"
    assert _route(32768, g, d, 2048, 2, nb) == "long"


@pytest.mark.parametrize("g,d,nb", [
    (1, 128, 1), (1, 128, 4), (4, 64, 1), (4, 64, 4), (12, 128, 1),
    (12, 128, 4), (6, 128, 1), (1, 112, 1), (1, 112, 4)])
def test_long_route_shared_memory_does_not_grow_with_s(g, d, nb):
    """decode_32k (S = 32,768) and long_500k (S = 524,288) at select_k =
    2,048 ask the same bytes of both kernels, within the card's opt-in,
    for every K/V width."""
    for elt in (4, 2, 1):
        at_32k = _long_smem_bytes(32768, g, d, d, 2048, elt, nb)
        assert at_32k == _long_smem_bytes(524288, g, d, d, 2048, elt, nb)
        assert max(at_32k) <= SMEM_OPTIN


def test_misaligned_copy_source_raises():
    """A tensor that does not start on the kernels' copy width is refused
    (16 bytes for a mirror with d % 16 == 0), not copied some other way."""
    buf = torch.zeros(4 * 128 + 4, dtype=torch.int8)
    aligned = buf[:512].view(4, 128)
    shifted = buf[4:].view(4, 128)
    build.check_copy_aligned("ragged_decode", mirror=(aligned, 16))
    with pytest.raises(ValueError, match="16-byte aligned"):
        build.check_copy_aligned("ragged_decode", mirror=(shifted, 16))
    build.check_copy_aligned("ragged_decode", mirror=(shifted, 4))


def _over_limit_calls(device):
    """Every decode, score and gather wrapper, called with G one above the
    kernels' limit."""
    g = ragged_mod.MAX_GROUPS + 1
    fills, args = _kernel_args(2, g, 16, 40, [7, 40], torch.bfloat16, device)
    sargs = _score_args(2, g, 16, 24, device)
    packed = list(sargs)
    packed[2] = quant.pack_int4(sargs[2])
    gargs = _gather_args(2, g, 16, 12, torch.bfloat16, device)
    return g, [lambda: ragged_decode(fills, *args, select_k=8),
               lambda: fused_mod.fused_decode(*args, select_k=8,
                                              num_blocks=2),
               lambda: approx_mod.approx_score(*sargs),
               lambda: approx_mod.approx_score_packed(*packed),
               lambda: gather_mod.gather_attention(*gargs)]


def test_group_count_above_the_limit_raises_before_any_launch():
    """G = MAX_GROUPS + 1 query rows per kv-head is refused by every
    decode, score and gather wrapper before anything else is checked (so
    also for a CPU tensor) and nothing launches; the plain versions behind
    `ops` take any G on the CPU."""
    assert ragged_mod.MAX_GROUPS == 16
    g, calls = _over_limit_calls("cpu")
    before = _all_launches()
    for call in calls:
        with pytest.raises(ValueError, match=f"G={g} "):
            call()
    assert _all_launches() == before
    _, args = _kernel_args(2, g, 16, 40, [7, 40], torch.bfloat16, "cpu")
    out, _ = ops.fused_decode(*args, select_k=8)
    assert out.shape == (2, g, 16) and _all_launches() == before


def test_cpu_tensor_takes_plain_path_without_a_launch():
    fills, args = _kernel_args(4, 2, 16, 40, [0, 7, 33, 40], torch.bfloat16,
                               "cpu")
    before = LAUNCHES["ragged_decode"]
    out, probs = ops.fused_decode(*args, select_k=8, fills=fills)
    assert LAUNCHES["ragged_decode"] == before
    out_r, probs_r = ref.fused_decode_ref(*args, select_k=8)
    torch.testing.assert_close(out, out_r, rtol=0, atol=0)
    torch.testing.assert_close(probs, probs_r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ragged_decode(fills, *args, select_k=8)


def _all_launches():
    return {**LAUNCHES, **fused_mod.LAUNCHES, **approx_mod.LAUNCHES,
            **gather_mod.LAUNCHES, **flash_mod.LAUNCHES}


def _score_args(bh, g, d, s, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    qq = torch.randint(-127, 128, (bh, g, d), generator=gen, dtype=torch.int8)
    kq = torch.randint(-8, 8, (bh, s, d), generator=gen, dtype=torch.int8)
    qs = torch.rand((bh, g), generator=gen) + 0.01
    ks = torch.rand((bh, s), generator=gen) + 0.01
    valid = (torch.rand((bh, s), generator=gen) < 0.8).to(torch.int8)
    return [a.to(device) for a in (qq, qs, kq, ks, valid)]


def _gather_args(bh, g, d, kk, kv_dtype, device, seed=0):
    """q, k, v, valid with mixed rows, row 0 without a valid slot and row 1
    all valid. With int8 codes for K/V, q carries the 1/127 of their
    dequantization scale, so the logits stay near 1 as in the model."""
    gen = torch.Generator().manual_seed(seed)
    q = torch.randn((bh, g, d), generator=gen)
    if kv_dtype == torch.int8:
        q = q / 127
        k = torch.randint(-127, 128, (bh, kk, d), generator=gen,
                          dtype=torch.int8)
        v = torch.randint(-127, 128, (bh, kk, d), generator=gen,
                          dtype=torch.int8)
    else:
        k = torch.randn((bh, kk, d), generator=gen).to(kv_dtype)
        v = torch.randn((bh, kk, d), generator=gen).to(kv_dtype)
    valid = (torch.rand((bh, kk), generator=gen) < 0.6).to(torch.int8)
    valid[0], valid[1] = 0, 1
    return [a.to(device) for a in (q, k, v, valid)]


def _prefill_args(b, hq, hk, n, d, device, seed=0):
    """q [B,Hq,N,d], k/v [B,Hk,N,d] in bf16 (the model's prompt pass)."""
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(torch.bfloat16).to(device)
            for shape in ((b, hq, n, d), (b, hk, n, d), (b, hk, n, d))]


def test_cpu_tensors_take_every_plain_version_without_a_launch():
    """Every entry point of `ops` on CPU tensors runs the plain version and
    launches no kernel; each kernel wrapper refuses a CPU tensor."""
    before = _all_launches()
    fills, args = _kernel_args(4, 2, 16, 40, [0, 7, 33, 40], torch.int8,
                               "cpu")
    for nb in (1, 2, 3):
        out, probs = ops.fused_decode(*args, select_k=6, num_blocks=nb)
        assert out.shape == (4, 2, 16) and probs.shape == (4, 40)
    torch.testing.assert_close(
        ops.fused_decode(*args, select_k=8, num_blocks=2),
        ref.fused_decode_ref(*args, select_k=8, num_blocks=2), rtol=0, atol=0)
    sargs = _score_args(3, 2, 16, 24, "cpu")
    torch.testing.assert_close(ops.approx_score(*sargs),
                               ref.approx_score_ref(*sargs), rtol=0, atol=0)
    gargs = _gather_args(3, 2, 16, 12, torch.bfloat16, "cpu")
    torch.testing.assert_close(ops.gather_attention(*gargs),
                               ref.gather_attention_ref(*gargs), rtol=0,
                               atol=0)
    fargs = _prefill_args(2, 4, 2, 40, 16, "cpu")
    ln = torch.as_tensor([40, 23], dtype=torch.int32)
    torch.testing.assert_close(
        ops.prefill_attention(*fargs, length=ln, obs_window=8),
        ref.prefill_attention_ref(*fargs, length=ln, obs_window=8), rtol=0,
        atol=0)
    flat = [x.reshape(-1, 40, 16) for x in fargs]
    torch.testing.assert_close(ops.flash_prefill(*flat, group=2),
                               ref.flash_prefill_ref(*flat, group=2), rtol=0,
                               atol=0)
    assert _all_launches() == before
    packed = list(sargs)
    packed[2] = quant.pack_int4(sargs[2])
    for call in (lambda: fused_mod.fused_decode(*args, select_k=8,
                                                num_blocks=2),
                 lambda: approx_mod.approx_score(*sargs),
                 lambda: approx_mod.approx_score_packed(*packed),
                 lambda: gather_mod.gather_attention(*gargs),
                 lambda: flash_mod.flash_prefill(
                     *flat, torch.full((8,), 40, dtype=torch.int32),
                     torch.zeros(4, 40), group=2, acc_group=2)):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert _all_launches() == before


def _needs_card():
    if not (torch.cuda.is_available()
            and torch.cuda.get_device_capability() >= (9, 0)):
        pytest.skip("needs a CUDA card of compute capability >= 9.0")


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,s,k,nb,kv", [
    (1, 128, 1088, 128, 4, torch.bfloat16), (1, 128, 1088, 128, 2, torch.int8),
    (4, 64, 576, 64, 8, torch.bfloat16), (4, 64, 576, 64, 4, torch.int8),
    (1, 128, 16384, 128, 4, torch.bfloat16), (4, 64, 8256, 128, 4, torch.int8),
    (12, 128, 1088, 128, 4, torch.bfloat16), (12, 128, 1088, 128, 4,
                                              torch.int8),
    (12, 128, 3900, 128, 4, torch.bfloat16),
    # zamba2-7b's shared attention block: d = 112
    (1, 112, 1088, 128, 4, torch.bfloat16), (1, 112, 1088, 128, 4,
                                             torch.int8),
])
def test_fused_kernel_matches_plain_version_on_card(g, d, s, k, nb, kv):
    _needs_card()
    bh = 16
    fill_list = [0, k - 5, 333, s] + list(
        np.random.default_rng(s).integers(1, s + 1, bh - 4))
    _, args = _kernel_args(bh, g, d, s, fill_list, kv, "cuda")
    before = fused_mod.LAUNCHES["fused_decode"]
    out, probs = fused_mod.fused_decode(*args, select_k=k, num_blocks=nb)
    torch.cuda.synchronize()
    assert fused_mod.LAUNCHES["fused_decode"] == before + 1
    out_r, probs_r = ref.fused_decode_ref(*args, select_k=k, num_blocks=nb)
    torch.testing.assert_close(out, out_r, rtol=0, atol=1e-3)
    torch.testing.assert_close(probs, probs_r, rtol=0, atol=1e-5)
    assert not out[0].any() and not probs[0].any()     # no valid slot


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,s,extreme", [
    (1, 128, 1088, False), (4, 64, 576, False), (12, 128, 1088, False),
    (16, 128, 576, False),
    # the tiling's edges: S no multiple of the 32-slot item, G = 16, d =
    # 112 and 40 (a padded last k-step; 8- and 4-byte packed loads), 256
    # and 4096 (k-chunks)
    (1, 128, 1045, False), (16, 128, 77, False), (16, 64, 1088, False),
    (3, 112, 333, False), (5, 40, 130, False), (16, 256, 259, False),
    (1, 4096, 64, False),
    # every q at -128 or 127 and every code at -8 or 7; row 0's slots sum
    # to |Σ| = 128·8·4096 = 2^22, the packed route's largest (16·Σ = 2^26)
    (1, 4096, 64, True)])
def test_approx_score_kernels_equal_plain_versions_on_card(g, d, s, extreme):
    _needs_card()
    qq, qs, kq, ks, valid = _score_args(16, g, d, s, "cuda")
    if s > 64:
        valid[1:, 32:64] = 0          # a tile with no valid slot
    if extreme:
        qq = torch.where(qq < 0, -128, 127).to(torch.int8)
        kq = torch.where(kq < 0, -8, 7).to(torch.int8)
        qq[0], kq[0] = -128, -8
    before = dict(approx_mod.LAUNCHES)
    torch.testing.assert_close(approx_mod.approx_score(qq, qs, kq, ks, valid),
                               ref.approx_score_ref(qq, qs, kq, ks, valid),
                               rtol=0, atol=0)
    packed = quant.pack_int4(kq)
    torch.testing.assert_close(
        approx_mod.approx_score_packed(qq, qs, packed, ks, valid),
        ref.approx_score_packed_ref(qq, qs, packed, ks, valid), rtol=0,
        atol=0)
    assert {n: approx_mod.LAUNCHES[n] - before[n] for n in before} == {
        "approx_score": 1, "approx_score_packed": 1}


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,kk,kv", [(1, 128, 128, torch.bfloat16),
                                       (4, 64, 128, torch.int8),
                                       (2, 64, 40, torch.float32),
                                       (12, 128, 128, torch.bfloat16),
                                       (16, 64, 128, torch.int8),
                                       # K no multiple of a warp step or of
                                       # the 256-row staging loop; d = 112;
                                       # rows past the shared-memory stage;
                                       # element-wise rows (int8 d = 40)
                                       (16, 128, 129, torch.bfloat16),
                                       (3, 112, 300, torch.int8),
                                       (1, 112, 129, torch.bfloat16),
                                       (12, 64, 257, torch.bfloat16),
                                       (1, 128, 1024, torch.float32),
                                       (16, 128, 700, torch.bfloat16),
                                       (2, 40, 130, torch.int8)])
def test_gather_attention_kernel_matches_plain_version_on_card(g, d, kk, kv):
    _needs_card()
    args = _gather_args(16, g, d, kk, kv, "cuda")
    args[3][2] = 0
    args[3][2, kk // 2] = 1                    # a row with one valid slot
    before = gather_mod.LAUNCHES["gather_attention"]
    out = gather_mod.gather_attention(*args)
    torch.cuda.synchronize()
    assert gather_mod.LAUNCHES["gather_attention"] == before + 1
    torch.testing.assert_close(out, ref.gather_attention_ref(*args), rtol=0,
                               atol=1e-4)
    assert torch.equal(out, gather_mod.gather_attention(*args))


def _misaligned(t, offset):
    """A contiguous copy of t starting `offset` bytes past 256-byte
    alignment."""
    n = t.numel() * t.element_size()
    buf = torch.empty(n + 256, dtype=torch.uint8, device=t.device)
    out = buf[offset:offset + n].view(t.dtype).view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.gpu
def test_composed_kernels_take_misaligned_rows_on_card():
    """approx_score's int8 route on a mirror 4- but not 8-byte aligned (its
    4-byte loads) and its packed route on mirrors 8- and 4- but not 16-
    and 8-byte aligned (8- and 4-byte loads) bit for bit, and
    gather_attention on K 8- but not 16-byte aligned (its element-wise
    route) within 1e-4, all bit-equal across two launches."""
    _needs_card()
    qq, qs, kq, ks, valid = _score_args(8, 2, 128, 200, "cuda")
    packed = quant.pack_int4(kq)
    kq = _misaligned(kq, 4)
    got = approx_mod.approx_score(qq, qs, kq, ks, valid)
    torch.testing.assert_close(got, ref.approx_score_ref(qq, qs, kq, ks,
                                                         valid),
                               rtol=0, atol=0)
    assert torch.equal(got, approx_mod.approx_score(qq, qs, kq, ks, valid))
    for offset in (8, 4):
        p = _misaligned(packed, offset)
        got = approx_mod.approx_score_packed(qq, qs, p, ks, valid)
        torch.testing.assert_close(got, ref.approx_score_packed_ref(
            qq, qs, p, ks, valid), rtol=0, atol=0)
        assert torch.equal(got, approx_mod.approx_score_packed(
            qq, qs, p, ks, valid))
    q, k, v, valid = _gather_args(8, 4, 128, 128, torch.bfloat16, "cuda")
    k = _misaligned(k, 8)
    out = gather_mod.gather_attention(q, k, v, valid)
    torch.testing.assert_close(out, ref.gather_attention_ref(q, k, v, valid),
                               rtol=0, atol=1e-4)
    assert torch.equal(out, gather_mod.gather_attention(q, k, v, valid))


@pytest.mark.gpu
@pytest.mark.parametrize("g", [1, 16])
def test_gather_attention_accepts_the_largest_k_it_took_before_on_card(g):
    """The kernel before this design took any K whose [G][d] f32 query and
    [G][K] f32 logits (and 32 bytes) fit in the shared memory one block may
    opt into. That largest K still launches and matches the plain version;
    one more is refused before any launch."""
    _needs_card()
    d = 128
    props = torch.cuda.get_device_properties(0)
    limit = int(getattr(props, "shared_memory_per_block_optin", 232448))
    kk = (limit - 4 * (g * d + 8)) // (4 * g)       # 4 (G d + G K + 8) <= limit
    args = _gather_args(3, g, d, kk, torch.bfloat16, "cuda")
    before = gather_mod.LAUNCHES["gather_attention"]
    out = gather_mod.gather_attention(*args)
    torch.cuda.synchronize()
    assert gather_mod.LAUNCHES["gather_attention"] == before + 1
    torch.testing.assert_close(out, ref.gather_attention_ref(*args), rtol=0,
                               atol=1e-4)
    more = _gather_args(3, g, d, kk + 1, torch.bfloat16, "cuda")
    with pytest.raises(ValueError, match="shared memory"):
        gather_mod.gather_attention(*more)
    assert gather_mod.LAUNCHES["gather_attention"] == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,s,k,kv", [
    (1, 128, 576, 64, torch.bfloat16), (1, 128, 1088, 128, torch.int8),
    (4, 64, 576, 64, torch.bfloat16), (4, 64, 576, 64, torch.int8),
    # long caches: smaller ring tiles, winners staged in chunks
    (1, 128, 16384, 128, torch.bfloat16), (1, 128, 22528, 128, torch.int8),
    (4, 64, 8256, 128, torch.bfloat16),
    # G = 12 (starcoder2-3b) and 6 (grok-1-314b); the largest S at G = 12
    (12, 128, 1088, 128, torch.bfloat16), (12, 128, 1088, 128, torch.int8),
    (12, 128, 3957, 128, torch.bfloat16), (6, 128, 1088, 128, torch.int8),
    (16, 64, 576, 64, torch.bfloat16),
    # zamba2-7b's shared attention block: d = 112
    (1, 112, 1088, 128, torch.bfloat16), (1, 112, 1088, 128, torch.int8),
])
def test_ragged_kernel_matches_plain_version_on_card(g, d, s, k, kv):
    _needs_card()
    bh = 16
    fill_list = [0, k - 5, 333, s] + list(
        np.random.default_rng(s).integers(1, s + 1, bh - 4))
    fills, args = _kernel_args(bh, g, d, s, fill_list, kv, "cuda")
    before = LAUNCHES["ragged_decode"]
    out, probs = ragged_decode(fills, *args, select_k=k)
    torch.cuda.synchronize()
    assert LAUNCHES["ragged_decode"] == before + 1
    out_r, probs_r = ref.fused_decode_ref(*args, select_k=k)
    torch.testing.assert_close(out, out_r, rtol=0, atol=1e-3)
    torch.testing.assert_close(probs, probs_r, rtol=0, atol=1e-5)
    assert not out[0].any() and not probs[0].any()     # the free lane


@pytest.mark.gpu
def test_decode_smem_queries_match_the_layout_on_card():
    """The kernels' own shared-memory queries, which the wrappers pick
    the route by, are the transcribed layouts: the single-CTA route's at
    every S, the long route's the same at S = 32,768 and 524,288."""
    _needs_card()
    from repro_torch.kernels import ragged_decode as ragged_mod
    rlib = ragged_mod._bind(build.load("ragged_decode"))
    flib = fused_mod._bind(build.load("fused_decode"))
    for (g, d), s, kind in itertools.product(
            ((1, 128), (4, 64), (2, 36), (12, 128), (6, 128), (16, 64)),
            (64, 1088, 3957, 8256, 22640, 22641), (0, 1, 2)):
        elt = (4, 2, 1)[kind]
        assert rlib.ragged_decode_smem_bytes(s, g, d, d, 128, kind) == \
            _decode_smem_bytes(s, g, d, d, 128, elt)
        for nb in (1, 4, 16):
            assert flib.fused_decode_smem_bytes(s, g, d, d, 128, nb, kind) \
                == _decode_smem_bytes(s, g, d, d, 128, elt, nb)
    for (g, d), s, kind, kernel in itertools.product(
            ((1, 128), (4, 64), (2, 36), (12, 128), (6, 128), (16, 64)),
            (32768, 524288), (0, 1, 2), (0, 1)):
        want = _long_smem_bytes(s, g, d, d, 2048, (4, 2, 1)[kind])[kernel]
        assert rlib.ragged_decode_long_smem_bytes(s, g, d, d, 2048, kind,
                                                  kernel) == want
        for nb in (1, 4, 16):
            assert flib.fused_decode_long_smem_bytes(
                s, g, d, d, 2048, nb, kind, kernel) == want


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,nb,top", SHORT_TOPS)
def test_wrapper_takes_the_short_route_exactly_where_it_fits_on_card(
        g, d, nb, top):
    """At the largest S the transcribed layout gives one CTA (rounded down
    to a multiple of nb) the wrapper launches the single-CTA route, at the
    next S that nb divides the long route, not a refusal; each counted
    under its own key alone and held to the plain version."""
    _needs_card()
    short = top - top % nb
    for s, key in ((short, ""), (short + nb, "_long")):
        assert _route(s, g, d, 128, 2, nb) == ("long" if key else "short")
        fills, args = _kernel_args(2, g, d, s, [s, s - 333], torch.bfloat16,
                                   "cuda")
        name, counter = (("ragged_decode", LAUNCHES) if nb == 1 else
                         ("fused_decode", fused_mod.LAUNCHES))
        before = dict(counter)
        if nb == 1:
            out, probs = ragged_decode(fills, *args, select_k=128)
        else:
            out, probs = fused_mod.fused_decode(*args, select_k=128,
                                                num_blocks=nb)
        torch.cuda.synchronize()
        assert counter[name + key] == before[name + key] + 1
        assert sum(counter.values()) == sum(before.values()) + 1
        out_r, probs_r = ref.fused_decode_ref(*args, select_k=128,
                                              num_blocks=nb)
        torch.testing.assert_close(out, out_r, rtol=0, atol=1e-3)
        torch.testing.assert_close(probs, probs_r, rtol=0, atol=1e-5)
        _assert_probs_at_scale(probs, probs_r, args[7], g)


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,s,k,kv", [
    (1, 128, 1088, 128, torch.bfloat16), (1, 128, 1088, 128, torch.int8),
    (4, 64, 576, 64, torch.bfloat16), (4, 64, 576, 64, torch.int8),
    (12, 128, 1088, 128, torch.bfloat16), (12, 128, 1088, 128, torch.int8),
    (1, 112, 1088, 128, torch.bfloat16), (1, 112, 1088, 128, torch.int8),
])
def test_ragged_kernel_winner_set_on_card(g, d, s, k, kv):
    """Tie-heavy inputs whose out names the winner set (`_set_args`): the
    kernel's winners are the plain version's, row by row."""
    _needs_card()
    bh = 16
    fill_list = [0, k - 5, 333, s] + list(
        np.random.default_rng(s).integers(1, s + 1, bh - 4))
    fills, args = _set_args(bh, g, d, s, fill_list, kv, "cuda")
    out, probs = ragged_decode(fills, *args, select_k=k)
    torch.cuda.synchronize()
    out_r, probs_r = ref.fused_decode_ref(*args, select_k=k)
    torch.testing.assert_close(out, out_r, rtol=0, atol=1e-3)
    torch.testing.assert_close(probs, probs_r, rtol=0, atol=1e-5)
    assert not out[0].any() and not probs[0].any()     # the free lane


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,s,k,nb,kv", [
    (1, 128, 1088, 128, 1, torch.bfloat16),
    (1, 128, 1088, 128, 4, torch.bfloat16),
    (1, 128, 1088, 128, 4, torch.int8),
    (4, 64, 576, 64, 2, torch.bfloat16), (4, 64, 576, 64, 8, torch.int8),
    (12, 128, 1088, 128, 4, torch.bfloat16),
    (12, 128, 1088, 128, 4, torch.int8),
    (1, 112, 1088, 128, 4, torch.bfloat16), (1, 112, 1088, 128, 4,
                                             torch.int8),
])
def test_fused_kernel_winner_set_on_card(g, d, s, k, nb, kv):
    """Tie-heavy inputs whose out names the winner set (`_set_args`): each
    selection block's winners are the plain version's, row by row."""
    _needs_card()
    bh = 16
    fill_list = [0, k - 5, 333, s] + list(
        np.random.default_rng(s).integers(1, s + 1, bh - 4))
    _, args = _set_args(bh, g, d, s, fill_list, kv, "cuda")
    out, probs = fused_mod.fused_decode(*args, select_k=k, num_blocks=nb)
    torch.cuda.synchronize()
    out_r, probs_r = ref.fused_decode_ref(*args, select_k=k, num_blocks=nb)
    torch.testing.assert_close(out, out_r, rtol=0, atol=1e-3)
    torch.testing.assert_close(probs, probs_r, rtol=0, atol=1e-5)
    assert not out[0].any() and not probs[0].any()     # no valid slot


def _bits_args(bh, g, d, s, fills, kv_dtype, device, seed=0):
    """Decode inputs whose out counts the winners' slot bits: every K row
    of a lane equal (each valid winner weighs 1/n), V[s][c] = bit c of s
    and vscale = 1, so n * out[c] is the number of valid winners with bit
    c set, an integer that one wrong winner moves by 1. Mirror codes in
    {0, 1}, query codes in {-1, 0, 1} and equal scales tie the selection
    sums in runs; ~15% of live slots protected, every valid slot of the
    last row."""
    fills, args = _set_args(bh, g, d, s, fills, kv_dtype, "cpu", seed)
    bits = (torch.arange(s)[:, None] >> torch.arange(d)[None, :]) & 1
    args[6] = torch.ones((bh, s))
    args[10] = bits.to(kv_dtype).expand(bh, s, d).contiguous()
    return fills.to(device), [a.to(device) for a in args]


def _winner_bits(out, args, select_k, nb=1):
    """n * out rounded, n the valid winners of each row (the plain
    version's count), as int64 [BH, G, d]."""
    n = _valid_winners(args, select_k, nb)
    return torch.round(out.cpu().double() * n[:, None, None]).long()


# probs at its own scale: a long row's probs average G / live (7.6e-6 at
# long_500k's G = 4), below an absolute 1e-5, so a zeroed row or a lost
# chunk would pass that alone
PROBS_RTOL, PROBS_SUM_RTOL = 1e-4, 1e-5


def _assert_probs_at_scale(probs, probs_r, valid, g):
    """Each slot's probs within PROBS_RTOL of |p| plus its row's uniform
    share G / live; each row's sum G (0 for a row with no live slot)
    within PROBS_SUM_RTOL of G."""
    p, pr = probs.double(), probs_r.double()
    live = (valid != 0).sum(-1, keepdim=True).double()
    err = (p - pr).abs() / (pr.abs() + g / live.clamp(min=1))
    assert float(err.max()) <= PROBS_RTOL, float(err.max())
    want = (live[:, 0] > 0).double() * g
    e_sum = float((p.sum(-1) - want).abs().max()) / g
    assert e_sum <= PROBS_SUM_RTOL, e_sum


def test_probs_at_scale_sees_what_an_absolute_limit_misses():
    """On the CPU, at long_500k's S and G on near-uniform inputs: a probs
    row zeroed, one 4,096-slot chunk of it zeroed, or that chunk left out
    of the row's softmax (the rest renormalised) all stay within the
    absolute 1e-5, and `_assert_probs_at_scale` refuses each."""
    bh, g, d, s = 2, 4, 16, 524288
    _, args = _set_args(bh, g, d, s, [s, s - 777], torch.bfloat16, "cpu")
    _, probs = ref.fused_decode_ref(*args, select_k=2048)
    _assert_probs_at_scale(probs, probs, args[7], g)
    row = probs.clone()
    row[1] = 0
    chunk = probs.clone()
    chunk[0, 4096:8192] = 0
    dropped = chunk.clone()
    dropped[0] *= g / dropped[0].double().sum()
    for bad in (row, chunk, dropped):
        torch.testing.assert_close(bad, probs, rtol=0, atol=1e-5)
        with pytest.raises(AssertionError):
            _assert_probs_at_scale(bad, probs, args[7], g)


def _valid_winners(args, select_k, nb):
    """The plain version's valid winner count per row (`ref.decode_race`,
    the race `ref.fused_decode_ref` runs)."""
    q, qq, qs, mirror, ms, ks, vs, valid, prot, k, v = [a.cpu() for a in args]
    _, idx = ref.decode_race(qq, qs, mirror, ms, valid, prot,
                             select_k=select_k, num_blocks=nb)
    return torch.gather(valid, 1, idx).sum(-1).double()


@pytest.mark.parametrize("nb", [1, 4])
def test_bits_inputs_count_the_winner_bits(nb):
    """On the CPU, n * out of the plain version on `_bits_args` inputs is
    the count of its race's valid winners with each slot bit set, in every
    group row, so the card tests can hold a kernel's winner set to it."""
    bh, g, d, s, k = 6, 2, 16, 4096, 128
    fills, args = _bits_args(bh, g, d, s, [s, s - 777, 0, k - 5, 3000, s],
                             torch.bfloat16, "cpu")
    out, _ = ref.fused_decode_ref(*args, select_k=k, num_blocks=nb)
    _, idx = ref.decode_race(*args[1:5], args[7], args[8], select_k=k,
                             num_blocks=nb)
    ok = torch.gather(args[7], 1, idx) != 0
    bits = (idx[..., None] >> torch.arange(d)) & 1
    want = (bits * ok[..., None]).sum(1)
    got = _winner_bits(out, args, k, nb)
    assert torch.equal(got, want[:, None, :].expand_as(got))
    assert not got[2].any() and int(ok[1].sum()) == k


# long caches at the narrow width of the CPU tests (d = 16, select_k =
# 2,048), and the served S = 1,088 on the single-CTA route
ROUTE_CASES = [
    (g, nb, 16, 32768, 2048, kv, "long") for g in (1, 4, 12)
    for nb in (1, 4) for kv in (torch.bfloat16, torch.int8)] + [
    # d = 36: the score kernel's 4-byte mirror copies (d % 16 != 0)
    (4, 1, 36, 32768, 2048, torch.bfloat16, "long"),
    (1, 4, 36, 32768, 2048, torch.int8, "long"),
    # long_500k: d = 32, so the slot bits (19 of them) fit in a V row
    (4, 1, 32, 524288, 2048, torch.int8, "long"),
    (4, 4, 32, 524288, 2048, torch.bfloat16, "long"),
    (1, 1, 16, 1088, 128, torch.bfloat16, "short"),
    (4, 4, 16, 1088, 128, torch.int8, "short")]


@pytest.mark.gpu
@pytest.mark.parametrize("g,nb,d,s,k,kv,want", ROUTE_CASES)
def test_decode_routes_match_plain_version_on_card(g, nb, d, s, k, kv, want):
    """Each route of both kernels against its plain version (out 1e-3,
    probs 1e-5 and, at its own scale, `_assert_probs_at_scale`), with the
    same winner sets (`_bits_args`) and two launches bit-equal; the
    wrapper takes the route the layout says and counts it under its own
    key. Rows: full, ragged, free, below select_k."""
    _needs_card()
    bh = 4
    fill_list = [s, s - 777, 0, k - 5]
    assert _route(s, g, d, k, kv.itemsize, nb) == want
    for make in (_kernel_args, _bits_args):
        fills, args = make(bh, g, d, s, fill_list, kv, "cuda")
        if nb == 1:
            calls = (("ragged_decode", ragged_mod.LAUNCHES, lambda: (
                ragged_decode(fills, *args, select_k=k))),)
        else:
            calls = ()
        calls += (("fused_decode", fused_mod.LAUNCHES, lambda: (
            fused_mod.fused_decode(*args, select_k=k, num_blocks=nb))),)
        out_r, probs_r = ref.fused_decode_ref(*args, select_k=k,
                                              num_blocks=nb)
        for name, counter, call in calls:
            key = name + ("_long" if want == "long" else "")
            before = dict(counter)
            out, probs = call()
            out2, probs2 = call()
            torch.cuda.synchronize()
            assert counter[key] == before[key] + 2
            assert sum(counter.values()) == sum(before.values()) + 2
            torch.testing.assert_close(out, out_r, rtol=0, atol=1e-3)
            torch.testing.assert_close(probs, probs_r, rtol=0, atol=1e-5)
            _assert_probs_at_scale(probs, probs_r, args[7], g)
            assert torch.equal(out, out2) and torch.equal(probs, probs2)
            assert not out[2].any() and not probs[2].any()   # free row
            dead = torch.arange(s, device="cuda")[None] >= fills[:, None]
            assert not probs[dead].any()
            if make is _bits_args:
                assert torch.equal(_winner_bits(out, args, k, nb),
                                   _winner_bits(out_r, args, k, nb))


@pytest.mark.gpu
def test_group_count_above_the_limit_raises_before_any_launch_on_card():
    """The same refusal for tensors on the card: no kernel launches."""
    _needs_card()
    g, calls = _over_limit_calls("cuda")
    before = _all_launches()
    for call in calls:
        with pytest.raises(ValueError, match=f"G={g} "):
            call()
    assert _all_launches() == before


def test_port_rules_cover_the_tooling_modules():
    names = {str(p.relative_to(ROOT)) for p in PORT_FILES}
    for mod in ("roofline", "dryrun", "report"):
        assert f"src/repro_torch/launch/{mod}.py" in names
