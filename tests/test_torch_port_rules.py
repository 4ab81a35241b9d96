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
from repro_torch.kernels.ragged_decode import LAUNCHES, granule, ragged_decode
from repro_torch.launch.serve import ServeLoop, greedy_generate
from repro_torch.models.transformer import Model

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


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
                                          (6, 1), (512, 16)])
def test_decode_kernels_copy_rows_at_their_widest_granule(nbytes, width):
    assert granule(nbytes) == width


# The decode kernels' shared-memory layout (`layout` in
# csrc/decode_common.cuh), transcribed: the bytes one CTA of ragged_decode
# (nb = 1) or fused_decode (nb selection blocks) asks for. The card test
# below holds the kernels' own query to it.
SMEM_OPTIN, RING_BYTES, RING_STAGES, CTA_THREADS, CTA_WARPS = (
    232448, 96 * 1024, 3, 256, 8)


def _decode_smem_bytes(s, g, d, dv, k, elt, nb=1):
    at = 0
    for n in (4 * g * s, 4 * s, s, s, 4 * g * d, g * d, 32, 4 * k, 4 * k,
              4 * k, 4 * k, 4 * g * k, 4 * CTA_THREADS,
              1024 * min(nb, CTA_WARPS), 8 * CTA_WARPS, 8 * CTA_WARPS,
              4 * CTA_WARPS, 16, 8 * (RING_STAGES + 2)):
        at = (at + n + 15) & ~15
    pair = ((d * elt + 15) & ~15) + ((dv * elt + 15) & ~15) + 32
    room = max(SMEM_OPTIN - at, 0)
    cap = min(max(room // pair, 1), k)
    ts = min(max(min(room, RING_BYTES) // (RING_STAGES * d), 1), CTA_THREADS)
    return at + max(RING_STAGES * ts * d, cap * pair)


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
])
def test_decode_shapes_fit_in_shared_memory(g, d, s, nb):
    for elt in (4, 2, 1):
        assert _decode_smem_bytes(s, g, d, d, 128, elt, nb) <= SMEM_OPTIN


@pytest.mark.parametrize("g,d,nb,floor", [
    (1, 128, 1, 22640), (1, 128, 4, 22332), (4, 64, 1, 10203),
    (4, 64, 4, 10064)])
def test_decode_kernels_largest_slot_count(g, d, nb, floor):
    """The largest S one CTA takes at select_k = 128 with bf16 K/V: only the
    [G + 1][S] words and two bytes a slot grow with S, and the mirror ring
    shrinks into what they leave."""
    assert _largest_s(g, d, 128, 2, nb) >= floor


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
@pytest.mark.parametrize("g,d,s", [(1, 128, 1088), (4, 64, 576)])
def test_approx_score_kernels_equal_plain_versions_on_card(g, d, s):
    _needs_card()
    qq, qs, kq, ks, valid = _score_args(16, g, d, s, "cuda")
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
                                       (2, 64, 40, torch.float32)])
def test_gather_attention_kernel_matches_plain_version_on_card(g, d, kk, kv):
    _needs_card()
    args = _gather_args(16, g, d, kk, kv, "cuda")
    before = gather_mod.LAUNCHES["gather_attention"]
    out = gather_mod.gather_attention(*args)
    torch.cuda.synchronize()
    assert gather_mod.LAUNCHES["gather_attention"] == before + 1
    torch.testing.assert_close(out, ref.gather_attention_ref(*args), rtol=0,
                               atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,s,k,kv", [
    (1, 128, 576, 64, torch.bfloat16), (1, 128, 1088, 128, torch.int8),
    (4, 64, 576, 64, torch.bfloat16), (4, 64, 576, 64, torch.int8),
    # long caches: smaller ring tiles, winners staged in chunks
    (1, 128, 16384, 128, torch.bfloat16), (1, 128, 22528, 128, torch.int8),
    (4, 64, 8256, 128, torch.bfloat16),
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
    """The kernels' own shared-memory query is the transcribed layout, and
    one slot past the largest S is refused before any launch."""
    _needs_card()
    from repro_torch.kernels import ragged_decode as ragged_mod
    rlib = ragged_mod._bind(build.load("ragged_decode"))
    flib = fused_mod._bind(build.load("fused_decode"))
    for (g, d), s, kind in itertools.product(
            ((1, 128), (4, 64), (2, 36)), (64, 1088, 8256, 22640, 22641),
            (0, 1, 2)):
        elt = (4, 2, 1)[kind]
        assert rlib.ragged_decode_smem_bytes(s, g, d, d, 128, kind) == \
            _decode_smem_bytes(s, g, d, d, 128, elt)
        for nb in (1, 4, 16):
            assert flib.fused_decode_smem_bytes(s, g, d, d, 128, nb, kind) \
                == _decode_smem_bytes(s, g, d, d, 128, elt, nb)
    s = _largest_s(1, 128, 128, 2) + 1
    fills, args = _kernel_args(1, 1, 128, s, [s], torch.bfloat16, "cuda")
    before = LAUNCHES["ragged_decode"]
    with pytest.raises(ValueError, match="shared memory"):
        ragged_decode(fills, *args, select_k=128)
    assert LAUNCHES["ragged_decode"] == before


@pytest.mark.gpu
@pytest.mark.parametrize("g,d,s,k,kv", [
    (1, 128, 1088, 128, torch.bfloat16), (1, 128, 1088, 128, torch.int8),
    (4, 64, 576, 64, torch.bfloat16), (4, 64, 576, 64, torch.int8),
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
