"""Rules of the port: it imports nothing of JAX or of the reference
package, its entry points never fall back to the CPU, a CPU tensor takes
the plain path without touching any kernel's launch count, and (on a card)
each kernel agrees with its plain version."""
import ast
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
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ragged_decode import LAUNCHES, ragged_decode
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
