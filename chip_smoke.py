#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order (no failure is caught: any one exits non-zero):
  1. device  — a CUDA card of compute capability >= 9.0, its name and
               power limit (nvidia-smi);
  2. build   — every kernel of the port, built from the sources in this
               checkout (nvcc, one process per source) unless the build
               cache holds them; the registers, stack and local memory
               (spills) of the prompt kernel's routes and the HMMA
               (tensor-core) instructions in their SASS (cuobjdump);
  3. kernels — each kernel against its plain PyTorch version on the card,
               at longchat-7b and granite-like (GQA) decode shapes, bf16
               and int8 K/V, and flash_prefill at the served prompt shape
               (4 x 2048, both contracts, lengths, obs_window, a row0
               chunk, chunked-vs-whole column sums bit for bit; bf16 on
               the tensor cores, its division checked bit for bit against
               the operator, its out error over 12 seeds with and without
               its exact rows beside the f32 route's; f32 on the CUDA
               cores), with CUDA-event
               times beside the reckoned bound (and beside the one PyTorch
               call that computes the function, where there is one);
  4. serve   — full-width longchat-7b (random bf16 weights from a seed)
               serving 8 requests on 4 lanes through `ServeLoop`, bf16 and
               int8 KV, first with global selection (the ragged_decode
               kernel), then with select_blocks = 4 (the fused_decode
               kernel); with bf16 KV and global selection, from one
               prefilled state the kernel's path and the composed plain
               decode path teacher-forced with the same tokens (the logit
               difference a step, the top-1 agreement held to a floor, the
               top-2 gap where it differs); each path's decode kernel
               must launch 32 x its decode steps and the other never, and the
               prompt pass flash_prefill 32 x its prefill dispatches with
               no plain prompt attention on the card; then the same
               requests with chunked admission (chunk_prefill = 512), held
               to the whole-admission run;
  5. paths   — one decode step from one prefilled state, fused kernel vs
               the composed plain path, layer-0 attention outputs and
               accumulated scores compared; with global selection also the
               three-pass step through the ops kernels (approx_score, int4
               approx_score_packed, top-k, gather_attention); then a few
               decode steps under torch.profiler: host wall per step
               against the device time of its kernels; and one 4 x 2048
               prompt pass under torch.profiler.

Every launch count is reset just before the path it counts and read just
after. The second-to-last line is a JSON object describing every kernel;
the last is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import ctypes
import dataclasses
import itertools
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import torch.nn.functional as F  # noqa: E402

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import baselines, quant, topk  # noqa: E402
from repro_torch.core.attention import decode_attention  # noqa: E402
from repro_torch.core.cache import (protected_mask,  # noqa: E402
                                    write_token)
from repro_torch.kernels import approx_score as approx_mod  # noqa: E402
from repro_torch.kernels import flash_prefill as flash_mod  # noqa: E402
from repro_torch.kernels import fused_decode as fused_mod  # noqa: E402
from repro_torch.kernels import gather_attention as gather_mod  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import ragged_decode as ragged_mod  # noqa: E402
from repro_torch.launch.serve import (Request, ServeLoop,  # noqa: E402
                                      bucket_length)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.attention_layer import decode_qkv  # noqa: E402
from repro_torch.models.transformer import (DecodeState,  # noqa: E402
                                            Model, layer_params)

HBM_BYTES_PER_S = 3.35e12          # H100 SXM datasheet peak rates
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
OUT_ATOL, PROBS_ATOL = 1e-3, 1e-5  # f32 on both sides, other sum order
GATHER_ATOL = 1e-4                 # f32 on both sides, other sum order
PATH_ATOL = 1e-2                   # bf16 activations
# flash_prefill: f32 probabilities, other sum order
FLASH_OUT_ATOL, FLASH_ACC_RTOL = 1e-3, 1e-4
# probabilities rounded to bf16 on both sides (the model's contract): one
# that lies within sum-order noise of a bf16 rounding boundary rounds the
# other way, by one bf16 ulp (at most 2^-7 of it), and so does its share of
# a column sum; the count of sums past FLASH_ACC_RTOL is printed
FLIP_ACC_RTOL = 2.0 ** -7
KEPT_MIN = 0.99                    # chunked vs whole: kept slots agreeing
# teacher-forced top-1 agreement of the kernel's and the composed decode
# path over 16 steps x 4 lanes: with random weights the two summation
# orders settle near-ties (top-2 gaps below 0.08) either way; the served
# weights and prompts agree in 59 of 64 on an H100, and the floor leaves
# four more near-ties room
TEACHER_AGREE_MIN = 55
COUNTERS = (ragged_mod.LAUNCHES, fused_mod.LAUNCHES, approx_mod.LAUNCHES,
            gather_mod.LAUNCHES, flash_mod.LAUNCHES)
SEED = 0
# the CLI's --prompt-len 2048 --new-tokens 32 --serve workload
PROMPT_LEN, NEW_TOKENS, LANES = 2048, 32, 4
CHUNK = 512                        # chunked admission's slice
LENS = (PROMPT_LEN, PROMPT_LEN // 2, PROMPT_LEN - 7, PROMPT_LEN // 3)
SERVED_SEED = len("served")        # the served prompt check's inputs


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def reset_launches():
    for c in COUNTERS:
        for name in c:
            c[name] = 0


def launch_counts():
    return {name: n for c in COUNTERS for name, n in c.items()}


def bound(nbytes, int8_ops=0.0, f32_flops=0.0, bf16_flops=0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (int8_ops / INT8_OPS_PER_S + f32_flops / F32_FLOPS_PER_S
             + bf16_flops / BF16_FLOPS_PER_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


SLEEP_CYCLES_PER_S = 2.0e9        # above the H100's SM clock: sleeps run long


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """The card's time per call, CUDA events around `iters` calls queued
    behind a sleep kernel that outlasts their host time, so a call whose
    wrapper takes longer on the host than its kernels on the card is
    timed by its kernels, back to back."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    fn()
    torch.cuda.synchronize()
    host_s = time.monotonic() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * (iters + 2) * host_s * SLEEP_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def cold_ms(fn, inputs, iters: int = 20) -> float:
    """`cuda_ms` of fn(*inputs[i]) over input sets taken in turn: with
    enough sets the 50 MB L2 holds none of a call's inputs when it starts,
    as in a served decode step, where the other layers run in between."""
    turns = itertools.cycle(inputs)
    return cuda_ms(lambda: fn(*next(turns)), iters)


COLD_SETS = 4                      # x ~90 MB of decode inputs: L2 is 50 MB


def call_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Wall time per call on the host, each call waited for: its wrapper's
    host time plus its kernels."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(iters):
        fn()
        torch.cuda.synchronize()
    return (time.monotonic() - t0) / iters * 1e3


# ---------------------------------------------------------------------------
# phase 2: what the compiler made of the prompt kernel
# ---------------------------------------------------------------------------

# the served instantiations: head dim 128, bf16-rounded (model contract)
# and f32 (TPU contract) probabilities
SERVED_TC = ("flash_prefill_tc_kernel<128, true>",
             "flash_prefill_tc_kernel<128, false>")


def prompt_kernel_name(text):
    """The demangled name of a prompt kernel in a mangled one, or None."""
    m = re.search(r"flash_prefill_tc_kernelILi(\d+)ELb([01])E", text)
    if m:
        return (f"flash_prefill_tc_kernel<{m.group(1)}, "
                f"{'true' if m.group(2) == '1' else 'false'}>")
    return "flash_prefill_f32_kernel" if "flash_prefill_f32_kernel" in text \
        else None


def cuobjdump():
    """The toolkit's cuobjdump, or None (then nothing is measured)."""
    tool = Path(build.nvcc()).parent / "cuobjdump"
    return tool if tool.exists() else None


def res_usage(tool, kernel, namer):
    """{name: registers, stack and local bytes} of every function of the
    built library `kernel` that `namer` names (cuobjdump -res-usage)."""
    lib = str(build.library_path(kernel))
    report, name = {}, None
    usage = subprocess.run([str(tool), "-res-usage", lib], capture_output=True,
                           text=True, check=True).stdout
    for line in usage.splitlines():
        if "Function " in line:
            name = namer(line)
        elif name and "REG:" in line:
            num = {k: int(v) for k, v in re.findall(r"(\w+):(\d+)", line)}
            report[name] = {"registers": num["REG"], "stack_bytes":
                            num["STACK"], "local_bytes": num["LOCAL"]}
            name = None
    return report


KV_MANGLED = {"f": "float", "13__nv_bfloat16": "bf16", "a": "int8"}


def decode_kernel_name(text):
    """`ragged_decode_kernel<16, bf16>` for a mangled decode kernel name
    (template arguments: the mirror copy width, the K/V type), or None."""
    m = re.search(r"(ragged|fused)_decode_kernelILi(\d+)E(f|a|13__nv_bfloat16)"
                  r"EEv", text)
    return (f"{m.group(1)}_decode_kernel<{m.group(2)}, "
            f"{KV_MANGLED[m.group(3)]}>") if m else None


def decode_kernel_report():
    """Registers, stack and local memory (spills) of every instantiation
    of the two decode kernels, printed; fails when one spills or a served
    one (16-byte mirror copies, bf16 and int8 K/V) is missing. Returns the
    served ones' numbers."""
    tool = cuobjdump()
    if tool is None:
        print("[build] cuobjdump not found: decode kernels' registers and "
              "spills not measured")
        return {}
    report = {}
    for kernel in ("ragged_decode", "fused_decode"):
        report.update(res_usage(tool, kernel, decode_kernel_name))
    for name in sorted(report):
        r = report[name]
        print(f"[build] {name}: {r['registers']} registers, "
              f"{r['stack_bytes']} B stack, {r['local_bytes']} B local "
              "(spills) (cuobjdump)")
    served = {k: {f"{kernel}_decode_kernel<16, {kv}>" for kv in
                  ("bf16", "int8")} for k, kernel in
              (("ragged_decode", "ragged"), ("fused_decode", "fused"))}
    for kernel, names in served.items():
        assert names <= set(report), (kernel, sorted(report))
    for name, r in report.items():
        assert r["stack_bytes"] == r["local_bytes"] == 0, (name, "spills")
    return {k: {"compiled": {n: report[n] for n in sorted(names)}}
            for k, names in served.items()}


def prompt_kernel_report():
    """Registers, stack and local memory (spills) of the prompt kernel's
    routes and the HMMA instructions in their SASS, read by cuobjdump from
    the built library, printed for the served instantiations and the f32
    route. Fails when a tensor-core kernel holds no HMMA or spills, or the
    served ones are missing. Returns the served ones' numbers."""
    tool = cuobjdump()
    if tool is None:
        print("[build] cuobjdump not found: registers, spills and HMMA count "
              "not measured")
        return {"compiled": "not measured"}
    lib = str(build.library_path("flash_prefill"))
    report = res_usage(tool, "flash_prefill", prompt_kernel_name)
    for r in report.values():
        r["hmma"] = 0
    name = None
    sass = subprocess.run([str(tool), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    for line in sass.splitlines():
        if "Function :" in line:
            name = prompt_kernel_name(line)
        elif name and "HMMA" in line:
            report[name]["hmma"] += 1
    for name in (*SERVED_TC, "flash_prefill_f32_kernel"):
        r = report.get(name, {})
        print(f"[build] {name}: {r.get('registers')} registers, "
              f"{r.get('stack_bytes')} B stack, {r.get('local_bytes')} B "
              f"local (spills), {r.get('hmma')} HMMA instructions in its "
              "SASS (cuobjdump)")
    tc = {n: r for n, r in report.items() if n.startswith("flash_prefill_tc")}
    spilled = {r["stack_bytes"] + r["local_bytes"] for r in tc.values()}
    print(f"[build] the {len(tc)} tensor-core instantiations (head dims 16 "
          f"to 128, both contracts): HMMA counts "
          f"{sorted({r['hmma'] for r in tc.values()})}, registers "
          f"{sorted({r['registers'] for r in tc.values()})}, stack + local "
          f"bytes {sorted(spilled)}")
    assert all(n in report for n in SERVED_TC), sorted(report)
    for name, r in tc.items():
        assert r["hmma"] > 0, (name, "no tensor-core instruction")
        assert r["stack_bytes"] == r["local_bytes"] == 0, (name, "spills")
    return {"compiled": {n: report[n] for n in SERVED_TC}}


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version, and its time
# ---------------------------------------------------------------------------


# the main path's decode shape: 4 lanes x 32 heads, S = 1088, select_k =
# 128, fills as the served prompts leave them (1024 kept, + decode; the
# 682-token prompt keeps all 682)
MAIN_FILLS = [f for f in (1040, 1030, 1050, 690) for _ in range(32)]


def kernel_inputs(bh, g, d, s, fills, kv_dtype, seed):
    """Decode-step inputs on the card; slots at or past a row's fill are
    invalid, as the cache keeps them; ~10% of live slots protected."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    fills = torch.as_tensor(fills, dtype=torch.int32, device=dev)
    valid = (torch.arange(s, device=dev)[None, :]
             < fills[:, None]).to(torch.int8)
    prot = (torch.rand((bh, s), generator=gen, device=dev)
            < 0.1).to(torch.int8) * valid

    def codes(*shape, hi=8):
        return torch.randint(-hi + 1, hi, shape, generator=gen, device=dev,
                             dtype=torch.int8)

    if kv_dtype == torch.int8:
        k, v = codes(bh, s, d, hi=128), codes(bh, s, d, hi=128)
        ks = torch.rand((bh, s), generator=gen, device=dev) * 0.02 + 0.001
        vs = torch.rand((bh, s), generator=gen, device=dev) * 0.02 + 0.001
    else:
        k = torch.randn((bh, s, d), generator=gen, device=dev).to(kv_dtype)
        v = torch.randn((bh, s, d), generator=gen, device=dev).to(kv_dtype)
        ks = torch.ones((bh, s), device=dev)
        vs = ks
    args = [torch.randn((bh, g, d), generator=gen, device=dev),
            codes(bh, g, d),
            torch.rand((bh, g), generator=gen, device=dev) + 0.05,
            codes(bh, s, d),
            torch.rand((bh, s), generator=gen, device=dev) + 0.05,
            ks, vs, valid, prot, k, v]
    return fills, args


def set_inputs(bh, g, d, s, fills, kv_dtype, seed):
    """Decode-step inputs on the card whose out names the winner set:
    every K row of a lane equal (each valid winner weighs 1/n), V = 1 and
    vscale[s] = s + 1, so out is the mean of the winners' s + 1 and one
    wrong winner moves it by at least 1/select_k. Mirror codes in {0, 1},
    query codes in {-1, 0, 1} and equal scales tie the selection sums in
    runs; ~15% of live slots protected, and every valid slot of the last
    two rows (more protected slots than select_k where the fill allows)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    fills = torch.as_tensor(fills, dtype=torch.int32, device=dev)
    valid = (torch.arange(s, device=dev)[None, :]
             < fills[:, None]).to(torch.int8)
    prot = (torch.rand((bh, s), generator=gen, device=dev)
            < 0.15).to(torch.int8) * valid
    prot[-2:] = valid[-2:]
    if kv_dtype == torch.int8:
        krow = torch.randint(-127, 128, (bh, 1, d), generator=gen,
                             device=dev, dtype=torch.int8)
        ks = torch.full((bh, s), 0.01, device=dev)
    else:
        krow = torch.randn((bh, 1, d), generator=gen, device=dev).to(kv_dtype)
        ks = torch.ones((bh, s), device=dev)
    vs = (torch.arange(s, device=dev, dtype=torch.float32) + 1).expand(
        bh, s).contiguous()
    args = [torch.randn((bh, g, d), generator=gen, device=dev),
            torch.randint(-1, 2, (bh, g, d), generator=gen, device=dev,
                          dtype=torch.int8),
            torch.full((bh, g), 0.5, device=dev),
            (torch.rand((bh, s, d), generator=gen, device=dev)
             < 0.08).to(torch.int8),
            torch.full((bh, s), 0.25, device=dev), ks, vs, valid, prot,
            krow.expand(bh, s, d).contiguous(),
            torch.ones((bh, s, d), dtype=kv_dtype, device=dev)]
    return fills, args


def input_tag(make, k):
    return ("" if make is kernel_inputs else
            f" tie-heavy set (a wrong winner moves out >= 1/k = {1 / k:.3g})")


def ragged_bound(fills, args, select_k):
    """(bound_ms, bound_by) for one call on these inputs: each input byte
    the function needs read once, each output written once. A row needs
    its live mirror rows and their scale and valid bytes, the whole prot
    row, and the K/V rows and scales of at most min(select_k, fill)
    winners; the integer scores and the f32 attention are the operations."""
    q, qq, qscale, mirror, mscale, ks, vs, valid, prot, k, v = args
    bh, g, d = q.shape
    s, dv = mirror.shape[1], v.shape[-1]
    live = torch.clamp(fills.long(), max=s).cpu().numpy()
    wins = np.minimum(live, select_k)
    kvb = k.element_size()
    per_row_fixed = (g * d * 4 + g * d + g * 4 + 4 + s      # q, qq, qs, fill, prot
                     + g * dv * 4 + s * 4)                   # out, probs
    nbytes = int((per_row_fixed + live * (d + 4 + 1)
                  + wins * ((d + dv) * kvb + 8)).sum())
    t, by = bound(nbytes, float((2 * g * d * live).sum()),
                  float((2 * g * wins * (d + dv)).sum()))
    return t, by, nbytes


def mixed_fills(bh, s, k, seed):
    """0 (a free lane), below select_k, not a multiple of the block, full,
    then random."""
    head = [0, k - 5, 333 if s > 333 else s - 3, s]
    rest = np.random.default_rng(seed).integers(1, s + 1, bh - len(head))
    return head + rest.tolist()


def phase_ragged():
    cases = [  # name, BH, G, d, S, select_k
        ("longchat S=576", 4 * 32, 1, 128, 576, 64),
        ("longchat S=1088", 4 * 32, 1, 128, 1088, 128),
        ("granite-like GQA", 4 * 8, 4, 64, 576, 64),
        # a long cache: smaller ring tiles, winners staged in chunks
        ("longchat S=16384", 16, 1, 128, 16384, 128),
    ]
    worst = 0.0
    for (ci, (name, bh, g, d, s, k)), kv, make in itertools.product(
            enumerate(cases), (torch.bfloat16, torch.int8),
            (kernel_inputs, set_inputs)):
        fills, args = make(bh, g, d, s, mixed_fills(bh, s, k, ci), kv,
                           seed=ci)
        out, probs = ragged_mod.ragged_decode(fills, *args, select_k=k)
        torch.cuda.synchronize()
        out_r, probs_r = ref.fused_decode_ref(*args, select_k=k)
        e_out = float((out - out_r).abs().max())
        e_probs = float((probs - probs_r).abs().max())
        free = fills == 0
        print(f"  {name} G={g} d={d} k={k} {str(kv)[6:]}{input_tag(make, k)}: "
              f"max|dout|={e_out:.3g} max|dprobs|={e_probs:.3g} free-lane "
              f"out/probs all zero="
              f"{not out[free].any() and not probs[free].any()}")
        assert e_out <= OUT_ATOL, (name, kv, make, e_out)
        assert e_probs <= PROBS_ATOL, (name, kv, make, e_probs)
        assert torch.isfinite(out).all() and torch.isfinite(probs).all()
        assert not out[free].any() and not probs[free].any()
        worst = max(worst, e_out, e_probs)

    timings = {}
    for kv in (torch.bfloat16, torch.int8):
        sets = [kernel_inputs(128, 1, 128, 1088, MAIN_FILLS, kv, seed=9 + i)
                for i in range(COLD_SETS)]
        fills, args = sets[0]

        def call(fl, *a):
            return ragged_mod.ragged_decode(fl, *a, select_k=128)

        ms = cuda_ms(lambda: call(fills, *args))
        cold = cold_ms(call, [(f, *a) for f, a in sets])
        wall = call_ms(lambda: call(fills, *args))
        plain = cuda_ms(lambda: ref.fused_decode_ref(*args, select_k=128))
        t, by, nbytes = ragged_bound(fills, args, 128)
        timings[str(kv)[6:]] = (cold, plain, t, by, None)
        timings[f"{str(kv)[6:]} warm"] = (ms, wall)
        print(f"  time main shape (BH=128 G=1 d=128 S=1088 k=128 "
              f"{str(kv)[6:]}): kernel {cold:.4f} ms with L2 cold "
              f"({COLD_SETS} input sets in turn; {ms:.4f} ms with its inputs "
              "in L2; "
              f"{wall:.4f} ms a call with the wrapper's host time), plain "
              f"{plain:.4f} ms, bound {t:.4f} ms ({by}: {nbytes} B at "
              "3.35 TB/s); library call: none (no single PyTorch call "
              "computes this function)")
    return worst, timings


def fused_bound(args, select_k, nb):
    """(bound_ms, bound_by, bytes) of one fused_decode call on these
    inputs: each row's valid mirror rows with their scale, the valid and
    prot bytes, the K/V rows and scales of the valid winners (per block at
    most k_loc, at most its valid slots), q, qq, qscale, out and probs."""
    q, qq, qscale, mirror, mscale, ks, vs, valid, prot, k, v = args
    bh, g, d = q.shape
    s, dv = mirror.shape[1], v.shape[-1]
    per_block = valid.reshape(bh, nb, s // nb).sum(-1).long()
    wins = torch.clamp(per_block, max=select_k // nb).sum(-1).cpu().numpy()
    live = valid.sum(-1).long().cpu().numpy()
    nbytes = int((g * d * 4 + g * d + g * 4 + 2 * s + g * dv * 4 + s * 4
                  + live * (d + 4)
                  + wins * ((d + dv) * k.element_size() + 8)).sum())
    t, by = bound(nbytes, float((2 * g * d * live).sum()),
                  float((2 * g * wins * (d + dv)).sum()))
    return t, by, nbytes


def phase_fused():
    """fused_decode against its plain version: nb in {1, 2, 4, 8} directly,
    and nb = 3 (1088 = 3 x 362 + 2: a ragged tail) through ops; timed at
    the served shape with nb = 4."""
    cases = [  # name, BH, G, d, S, select_k
        ("longchat S=1088", 4 * 32, 1, 128, 1088, 128),
        ("granite-like GQA S=1088", 4 * 8, 4, 64, 1088, 128),
        ("granite-like GQA S=8256", 8, 4, 64, 8256, 128),
    ]
    worst = 0.0
    for (ci, (name, bh, g, d, s, k)), kv, make in itertools.product(
            enumerate(cases), (torch.bfloat16, torch.int8),
            (kernel_inputs, set_inputs)):
        fills, args = make(bh, g, d, s, mixed_fills(bh, s, k, ci), kv,
                           seed=10 + ci)
        free = fills == 0
        for nb in (1, 2, 4, 8, 3):
            if nb == 3:      # select_k divisible by 3, S padded by ops
                kk = k - k % 3
                out, probs = ops.fused_decode(*args, select_k=kk,
                                              num_blocks=nb)
                pad = [F.pad(a, [0, 0] * (a.dim() - 2) + [0, -s % nb])
                       for a in args[3:]]
                out_r, probs_r = ref.fused_decode_ref(
                    *args[:3], *pad, select_k=kk, num_blocks=nb)
                probs_r = probs_r[:, :s]
            else:
                kk = k
                out, probs = fused_mod.fused_decode(*args, select_k=k,
                                                    num_blocks=nb)
                out_r, probs_r = ref.fused_decode_ref(
                    *args, select_k=k, num_blocks=nb)
            torch.cuda.synchronize()
            e_out = float((out - out_r).abs().max())
            e_probs = float((probs - probs_r).abs().max())
            print(f"  {name} G={g} d={d} k={kk} nb={nb} {str(kv)[6:]}"
                  f"{input_tag(make, kk)}: max|dout|={e_out:.3g} "
                  f"max|dprobs|={e_probs:.3g}")
            assert e_out <= OUT_ATOL, (name, kv, nb, e_out)
            assert e_probs <= PROBS_ATOL, (name, kv, nb, e_probs)
            assert torch.isfinite(out).all() and torch.isfinite(probs).all()
            assert not out[free].any() and not probs[free].any()
            worst = max(worst, e_out, e_probs)
    timings = {}
    for kv in (torch.bfloat16, torch.int8):
        sets = [kernel_inputs(128, 1, 128, 1088, MAIN_FILLS, kv, seed=9 + i)[1]
                for i in range(COLD_SETS)]
        args = sets[0]

        def call(*a):
            return fused_mod.fused_decode(*a, select_k=128, num_blocks=4)

        ms = cuda_ms(lambda: call(*args))
        cold = cold_ms(call, sets)
        wall = call_ms(lambda: call(*args))
        plain = cuda_ms(lambda: ref.fused_decode_ref(*args, select_k=128,
                                                     num_blocks=4))
        t, by, nbytes = fused_bound(args, 128, 4)
        timings[str(kv)[6:]] = (cold, plain, t, by, None)
        timings[f"{str(kv)[6:]} warm"] = (ms, wall)
        print(f"  time main shape (BH=128 G=1 d=128 S=1088 k=128 nb=4 "
              f"{str(kv)[6:]}): kernel {cold:.4f} ms with L2 cold "
              f"({COLD_SETS} input sets in turn; {ms:.4f} ms with its inputs "
              "in L2; "
              f"{wall:.4f} ms a call with the wrapper's host time), plain "
              f"{plain:.4f} ms, bound {t:.4f} ms ({by}: {nbytes} B at "
              "3.35 TB/s); library call: none (no single PyTorch call "
              "scores, races and attends)")
    return worst, timings


def score_inputs(bh, g, d, s, fills, seed, q_hi=128, k_hi=128):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    fills = torch.as_tensor(fills, dtype=torch.int32, device=dev)
    valid = (torch.arange(s, device=dev)[None, :]
             < fills[:, None]).to(torch.int8)
    qq = torch.randint(-q_hi + 1, q_hi, (bh, g, d), generator=gen,
                       device=dev, dtype=torch.int8)
    kq = torch.randint(-k_hi + 1, k_hi, (bh, s, d), generator=gen,
                       device=dev, dtype=torch.int8)
    qs = torch.rand((bh, g), generator=gen, device=dev) + 0.05
    ks = torch.rand((bh, s), generator=gen, device=dev) + 0.05
    return qq, qs, kq, ks, valid


def score_bound(qq, kq_row_bytes, valid):
    """qq, qscale, the valid rows of the mirror with their scale, the valid
    bytes and the [G, S] f32 output."""
    bh, g, d = qq.shape
    s = valid.shape[1]
    live = int(valid.sum())
    nbytes = (bh * (g * d + g * 4 + s + g * s * 4)
              + live * (kq_row_bytes + 4))
    t, by = bound(nbytes, int8_ops=2.0 * g * d * live)
    return t, by, nbytes


def phase_approx():
    """approx_score and approx_score_packed against their plain versions:
    equal bit for bit."""
    for ci, (name, bh, g, d, s) in enumerate([
            ("longchat S=1088", 128, 1, 128, 1088),
            ("granite-like GQA S=1088", 32, 4, 64, 1088)]):
        fills = mixed_fills(bh, s, 128, ci)
        qq, qs, kq, ks, valid = score_inputs(bh, g, d, s, fills, 20 + ci)
        got = approx_mod.approx_score(qq, qs, kq, ks, valid)
        want = ref.approx_score_ref(qq, qs, kq, ks, valid)
        kq4 = torch.clamp(kq, -8, 7)
        packed = quant.pack_int4(kq4)
        got4 = approx_mod.approx_score_packed(qq, qs, packed, ks, valid)
        want4 = ref.approx_score_packed_ref(qq, qs, packed, ks, valid)
        torch.cuda.synchronize()
        same, same4 = torch.equal(got, want), torch.equal(got4, want4)
        print(f"  {name} G={g} d={d}: approx_score bit-equal {same}, "
              f"packed bit-equal {same4}")
        assert same and same4, name
    timings = {}
    # the served operands: 4-bit queries, a 3-bit mirror
    qq, qs, kq, ks, valid = score_inputs(128, 1, 128, 1088, MAIN_FILLS, 29,
                                         q_hi=8, k_hi=4)
    packed = quant.pack_int4(kq)
    for name, fn, plain_fn, kqx, row in (
            ("approx_score", approx_mod.approx_score, ref.approx_score_ref,
             kq, 128),
            ("approx_score_packed", approx_mod.approx_score_packed,
             ref.approx_score_packed_ref, packed, 64)):
        ms = cuda_ms(lambda: fn(qq, qs, kqx, ks, valid))
        plain = cuda_ms(lambda: plain_fn(qq, qs, kqx, ks, valid))
        t, by, nbytes = score_bound(qq, row, valid)
        timings[name] = (ms, plain, t, by, None)
        print(f"  time {name} main shape (BH=128 G=1 d=128 S=1088): kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {t:.4f} ms ({by}: "
              f"{nbytes} B); library call: none (torch has no int8 x int8 "
              "-> int32 batched product on the card)")
    return 0.0, timings


def gather_inputs(bh, g, d, kk, kv, seed, frac=0.6):
    """q, k, v, valid: mixed rows, row 0 without a valid slot, row 1 all
    valid. int8 K/V are raw codes, so q carries their 1/127 scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dev = "cuda"
    q = torch.randn((bh, g, d), generator=gen, device=dev)
    if kv == torch.int8:
        q = q / 127
        k, v = (torch.randint(-127, 128, (bh, kk, d), generator=gen,
                              device=dev, dtype=torch.int8) for _ in "kv")
    else:
        k, v = (torch.randn((bh, kk, d), generator=gen, device=dev).to(kv)
                for _ in "kv")
    valid = (torch.rand((bh, kk), generator=gen, device=dev)
             < frac).to(torch.int8)
    valid[0], valid[1] = 0, 1
    return q, k, v, valid


def phase_gather():
    """gather_attention against its plain version, K = 128, including
    rows with no valid slot (the mean of their V rows, as the oracle)."""
    worst = 0.0
    for ci, (name, bh, g, d) in enumerate([("longchat", 128, 1, 128),
                                           ("granite-like GQA", 32, 4, 64)]):
        for kv in (torch.bfloat16, torch.int8):
            args = gather_inputs(bh, g, d, 128, kv, 30 + ci)
            out = gather_mod.gather_attention(*args)
            want = ref.gather_attention_ref(*args)
            torch.cuda.synchronize()
            err = float((out - want).abs().max())
            print(f"  {name} G={g} d={d} K=128 {str(kv)[6:]}: "
                  f"max|dout|={err:.3g}")
            assert err <= GATHER_ATOL and torch.isfinite(out).all(), (name, kv)
            worst = max(worst, err)
    q, k, v, valid = gather_inputs(128, 1, 128, 128, torch.bfloat16, 39,
                                   frac=1.0)
    ms = cuda_ms(lambda: gather_mod.gather_attention(q, k, v, valid))
    plain = cuda_ms(lambda: ref.gather_attention_ref(q, k, v, valid))
    qb, mask = q.to(torch.bfloat16), (valid != 0)[:, None, :]
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(qb, k, v,
                                                         attn_mask=mask))
    nbytes = (128 * (1 * 128 * 4 + 128 + 1 * 128 * 4)
              + int(valid.sum()) * (128 + 128) * 2)
    t, by = bound(nbytes, f32_flops=4.0 * int(valid.sum()) * 128)
    print(f"  time main shape (BH=128 G=1 d=128 K=128 bf16): kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, bound {t:.4f} ms ({by}: "
          f"{nbytes} B); library call F.scaled_dot_product_attention "
          f"(bf16 q, boolean mask) {lib:.4f} ms")
    return worst, {"gather_attention": (ms, plain, t, by, lib)}


# the served prompt pass: 4 lanes x 32 heads, N = 2048, d = 128, bf16, the
# served prompts' lengths
def prompt_inputs(b, hq, hk, n, d, dtype, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    return [torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype)
            for h in (hq, hk, hk)]


def pad_cols_zero(acc, lengths):
    """acc [B, H, N] is exactly 0 at every column at or past its length."""
    cols = torch.arange(acc.shape[-1], device=acc.device)
    pad = (cols[None, :] >= lengths[:, None].long())[:, None, :]
    return not acc.masked_select(pad.expand_as(acc)).any()


def acc_errors(acc, want):
    """(max relative error where want != 0, whether acc is 0 exactly where
    want is)."""
    nz = want != 0
    d = (acc - want).abs()
    return (float((d[nz] / want[nz].abs()).max()),
            bool(torch.equal(acc[~nz], want[~nz])))


def check_model_contract(name, b, hq, hk, n, d, dtype, lengths, obs=0,
                         row0=0, c=None, seed=0):
    """ops.prefill_attention (the model's contract) against its plain
    version → (max abs error of out, max relative error of acc)."""
    c = n - row0 if c is None else c
    q, k, v = prompt_inputs(b, hq, hk, n, d, dtype, seed)
    q_c = q[:, :, row0:row0 + c]
    ln = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    acc = torch.zeros((b, hk, n), device="cuda")
    out, acc = ops.prefill_attention(q_c, k, v, acc, row0=row0, length=ln,
                                     obs_window=obs)
    want, want_acc = ref.prefill_attention_ref(q_c, k, v, row0=row0,
                                               length=ln, obs_window=obs)
    torch.cuda.synchronize()
    acc_tol = FLIP_ACC_RTOL if v.dtype == torch.bfloat16 else FLASH_ACC_RTOL
    d_out = (out - want).abs()
    e_out = float(d_out.max())
    e_rel, zeros = acc_errors(acc, want_acc)
    over = int(((acc - want_acc).abs() > FLASH_ACC_RTOL * want_acc.abs()
                ).sum())
    pads = pad_cols_zero(acc, ln)
    print(f"  model contract {name} B={b} Hq={hq} Hk={hk} N={n} d={d} "
          f"rows [{row0}, {row0 + c}) obs={obs} {str(dtype)[6:]}: "
          f"max|dout|={e_out:.3g} (atol {FLASH_OUT_ATOL}; "
          f"{int((d_out > FLASH_OUT_ATOL).sum())} of {out.numel()} outputs "
          f"past it), acc max rel {e_rel:.3g} (rtol {acc_tol:.3g}; {over} of "
          f"{acc.numel()} entries past rtol {FLASH_ACC_RTOL}), pad columns "
          f"exactly 0 {pads}")
    assert torch.isfinite(out).all() and torch.isfinite(acc).all(), name
    assert e_out <= FLASH_OUT_ATOL and e_rel <= acc_tol, (name, e_out, e_rel)
    assert zeros and pads, name
    return e_out, e_rel


def check_tpu_contract(name, bh, g, n, d, dtype, lengths, seed):
    """ops.flash_prefill (the TPU contract: f32 probabilities, per-q-head
    acc, out in q's dtype) against its plain version; asserts, and reports
    nothing to the kernels line, which carries the main path's contract."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn((rows, n, d), generator=gen, device="cuda").to(
        dtype) for rows in (bh, bh // g, bh // g))
    ln = torch.as_tensor(lengths, dtype=torch.int32, device="cuda")
    out, acc = ops.flash_prefill(q, k, v, group=g, lengths=ln)
    want, want_acc = ref.flash_prefill_ref(q, k, v, group=g, lengths=ln)
    torch.cuda.synchronize()
    # a bf16 out is rounded on both sides: one bf16 ulp (2^-7 relative)
    rtol = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    d_out = (out.float() - want.float()).abs()
    ok_out = bool((d_out <= FLASH_OUT_ATOL + rtol * want.float().abs()).all())
    e_rel, zeros = acc_errors(acc, want_acc)
    pads = pad_cols_zero(acc[:, None, :], ln)
    print(f"  TPU contract {name} BH={bh} G={g} N={n} d={d} {str(dtype)[6:]}:"
          f" max|dout|={float(d_out.max()):.3g} (atol {FLASH_OUT_ATOL} + "
          f"rtol {rtol:.3g}) ok {ok_out}, acc max rel {e_rel:.3g} (rtol "
          f"{FLASH_ACC_RTOL}), pad columns exactly 0 {pads}")
    assert ok_out and e_rel <= FLASH_ACC_RTOL and zeros and pads, name


def flash_bound(lengths, heads, d, kv_bytes):
    """(bound_ms, bound_by, flops, bytes) of one model-contract call over a
    whole prompt, counting only what its output needs: the rows below each
    lane's length (rows past it are outputs the contract discards), and
    two causal products over each q-head's L (L + 1) / 2 live (row, column)
    pairs (q.k and p.v: out and the column sums both come from them) at the
    peak of the inputs' type (bf16: the tensor cores; f32: the CUDA cores,
    since the tensor cores would round f32 to TF32); those rows of q, k, v
    read once and of the f32 out written, acc's L columns read and
    written, one length per lane."""
    ln = np.asarray(lengths, dtype=np.float64)
    flops = heads * float((2 * 2 * d * ln * (ln + 1) / 2).sum())
    nbytes = (heads * int(ln.sum()) * (d * (3 * kv_bytes + 4) + 2 * 4)
              + 4 * len(ln))
    if kv_bytes == 4:
        t, by = bound(nbytes, f32_flops=flops)
    else:
        t, by = bound(nbytes, bf16_flops=flops)
    return t, by, flops, nbytes


def check_division(blocks=65536, per_thread=64, seed=1):
    """The bf16 route divides without the operator's per-element branch
    (div_fast); check it equals the operator bit for bit on 2^30 operand
    pairs drawn over the range the kernel gives it."""
    lib = build.load("flash_prefill")
    fn = lib.flash_prefill_div_check
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                   ctypes.c_ulonglong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    build.check_launch("flash_prefill_div_check", fn(
        bad.data_ptr(), blocks, per_thread, seed,
        torch.cuda.current_stream().cuda_stream))
    n, n_bad = blocks * 256 * per_thread, int(bad)
    print(f"  division without its branch (div_fast) vs the operator: "
          f"{n_bad} of {n} quotients differ (a in [2^-64, 1], b in [1, 2^32))")
    assert n_bad == 0


def f32_route_rounded(q, k, v, ln):
    """The f32 route (CUDA cores, the design PR 13 served bf16 prompts with:
    each logit an f32 FMA chain over d) on f32 copies of bf16 q, k, v, with
    the model contract's bf16-rounded probabilities → out [B, Hq, N, d].
    A direct launch: the wrapper rounds p only for bf16 V."""
    b, hq, n, d = q.shape
    bh = b * hq
    qf, kf, vf = (x.float().reshape(bh, n, d) for x in (q, k, v))
    lens = torch.repeat_interleave(ln, hq)
    out = torch.empty((bh, n, d), device="cuda")
    part = torch.empty((bh, -(-n // 64), n), device="cuda")
    acc = torch.zeros((bh, n), device="cuda")
    lib = flash_mod._bind(build.load("flash_prefill"))
    build.check_launch("flash_prefill", lib.flash_prefill_launch(
        0, 0, qf.data_ptr(), kf.data_ptr(), vf.data_ptr(), lens.data_ptr(),
        out.data_ptr(), part.data_ptr(), acc.data_ptr(), bh, n, n, d, 1, 1,
        0, 0, 1, ctypes.c_float(1.0 / math.sqrt(d)), ctypes.c_float(0.0),
        torch.cuda.current_stream().cuda_stream))
    return out.reshape(b, hq, n, d)


def exact_rows_survey(seeds=range(12)):
    """The model contract's out error at the served prompt shape over
    `seeds`: the bf16 route as served (exact rows below EXACT_BELOW), the
    same with no exact rows (tensor-core logits alone), and the f32 route
    with rounded probabilities. Printed, not asserted (the check above
    holds the served route at its seed); also the share of exact rows."""
    ln = torch.as_tensor(LENS, dtype=torch.int32, device="cuda")
    past = {"served": 0, "tensor-core logits only": 0, "f32 route": 0}
    for seed in seeds:
        q, k, v = prompt_inputs(4, 32, 32, 2048, 128, torch.bfloat16, seed)
        want, _ = ref.prefill_attention_ref(q, k, v, length=ln)
        outs = {"served": ops.prefill_attention(q, k, v, length=ln)[0]}
        below = flash_mod.EXACT_BELOW
        flash_mod.EXACT_BELOW = 0.0
        try:
            outs["tensor-core logits only"] = ops.prefill_attention(
                q, k, v, length=ln)[0]
        finally:
            flash_mod.EXACT_BELOW = below
        outs["f32 route"] = f32_route_rounded(q, k, v, ln)
        line = []
        for key, out in outs.items():
            d_out = (out - want).abs()
            n_past = int((d_out > FLASH_OUT_ATOL).sum())
            past[key] += n_past > 0
            line.append(f"{key} {float(d_out.max()):.3g} ({n_past} past)")
        print(f"  seed {seed}, model contract max|dout|: " + ", ".join(line))
        if seed == SERVED_SEED:
            # rows with l < EXACT_BELOW: largest probability above 1/32
            n_exact = 0
            causal = torch.ones((2048, 2048), dtype=torch.bool,
                                device="cuda").tril()
            for bi in range(4):
                s_ = torch.matmul(q[bi].float(), k[bi].float().transpose(
                    -1, -2)) / math.sqrt(128)
                p_max = torch.softmax(s_.masked_fill(~causal, ref.NEG_INF),
                                      -1).amax(-1)
                n_exact += int((p_max > 1.0 / flash_mod.EXACT_BELOW).sum())
                del s_, p_max
    print(f"  seeds with an output past {FLASH_OUT_ATOL}, of {len(seeds)}: "
          + ", ".join(f"{k} {v}" for k, v in past.items()) + f"; exact rows "
          f"at seed {SERVED_SEED}: {n_exact} of {4 * 32 * 2048}")
    return {"survey_seeds": len(seeds),
            "survey_seeds_past_atol": past,
            "exact_rows": n_exact}


def phase_flash():
    check_division()
    out_err, acc_rel = 0.0, 0.0
    served = [n for n in LENS]
    gqa = [1000, 517, 999, 64]
    for args, kw in (
            (("served", 4, 32, 32, 2048, 128, torch.bfloat16, served, 0), {}),
            (("served", 4, 32, 32, 2048, 128, torch.bfloat16, served, 32), {}),
            (("granite-like GQA ragged N", 4, 32, 8, 1000, 64,
              torch.bfloat16, gqa, 0), {}),
            (("f32 GQA", 2, 8, 2, 1000, 128, torch.float32, [1000, 600], 16),
             {}),
            (("served chunk", 4, 32, 32, 2048, 128, torch.bfloat16, served),
             {"row0": 1024, "c": 512, "seed": 5})):
        e_out, e_rel = check_model_contract(
            *args, **{"seed": len(args[0]), **kw})
        out_err, acc_rel = max(out_err, e_out), max(acc_rel, e_rel)
    check_tpu_contract("served", 128, 1, 2048, 128, torch.bfloat16,
                       [n for n in served for _ in range(32)], 6)
    check_tpu_contract("granite-like GQA ragged N", 128, 4, 1000, 64,
                       torch.float32, [n for n in gqa for _ in range(32)], 7)
    survey = exact_rows_survey()

    # chunked (4 x 512 rows, acc added in place) vs whole prompt, bit for bit
    q, k, v = prompt_inputs(4, 32, 32, 2048, 128, torch.bfloat16, 8)
    ln = torch.as_tensor(served, dtype=torch.int32, device="cuda")
    acc_w = torch.zeros((4, 32, 2048), device="cuda")
    out_w, _ = ops.prefill_attention(q, k, v, acc_w, row0=0, length=ln)
    acc_c = torch.zeros_like(acc_w)
    outs = [ops.prefill_attention(q[:, :, r0:r0 + 512], k, v, acc_c, row0=r0,
                                  length=ln)[0]
            for r0 in range(0, 2048, 512)]
    torch.cuda.synchronize()
    same_acc = torch.equal(acc_c, acc_w)
    same_out = torch.equal(torch.cat(outs, dim=2), out_w)
    print(f"  chunked (4 x 512 rows into one acc) vs whole prompt on the "
          f"card: column sums bit-equal {same_acc}, outputs bit-equal "
          f"{same_out}")
    assert same_acc and same_out

    # times at the served shape, the main path's contract
    qf, kf, vf = (x.reshape(128, 2048, 128) for x in (q, k, v))
    lens = torch.repeat_interleave(ln, 32)
    acc = torch.zeros((128, 2048), device="cuda")
    ms = cuda_ms(lambda: flash_mod.flash_prefill(qf, kf, vf, lens, acc,
                                                 group=1, acc_group=1))
    plain = cuda_ms(lambda: ref.prefill_attention_ref(q, k, v, length=ln))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                         is_causal=True))
    t, by, flops, nbytes = flash_bound(served, 32, 128, 2)
    # this design's own work: three causal products (q.k in both sweeps,
    # p.v) over all N rows of every lane
    design = 3.0 * 2 * 128 * 128 * 2048 * 2049 / 2
    print(f"  time served shape (B=4 Hq=Hk=32 N=2048 d=128 bf16, lengths "
          f"{served}, model contract, tensor cores): kernel pair {ms:.4f} "
          f"ms, plain {plain:.4f} ms, bound {t:.4f} ms ({by}: {flops:.4g} "
          f"flop, two causal products over the rows below each length, at "
          f"the 989 TF/s bf16 tensor-core peak; {nbytes} B, "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms at 3.35 TB/s), kernel / "
          f"bound {ms / t:.1f}x; library call F.scaled_dot_product_attention("
          f"is_causal=True), out only, no column sums: {lib:.4f} ms")
    # the same without exact rows: the tensor-core logits alone
    below = flash_mod.EXACT_BELOW
    flash_mod.EXACT_BELOW = 0.0
    try:
        ms_tc = cuda_ms(lambda: flash_mod.flash_prefill(
            qf, kf, vf, lens, acc, group=1, acc_group=1))
    finally:
        flash_mod.EXACT_BELOW = below
    print(f"  time served shape, model contract, no exact rows (every logit "
          f"on the tensor cores): kernel pair {ms_tc:.4f} ms; the exact rows "
          f"(l < {flash_mod.EXACT_BELOW:g}) add {ms - ms_tc:.4f} ms")
    print(f"  this design's work, three causal products over all N rows: "
          f"{design:.4g} flop, {design / BF16_FLOPS_PER_S * 1e3:.4f} ms at "
          f"the bf16 tensor-core peak; the kernel pair does it at "
          f"{design / ms / 1e9:.1f} TF/s")
    # the TPU contract on the same route: f32 p as hi + lo, two p.v products
    ms_tpu = cuda_ms(lambda: flash_mod.flash_prefill(
        qf, kf, vf, lens, acc, group=1, acc_group=1, model=False))
    print(f"  time served shape, TPU contract (f32 probabilities, bf16 out), "
          f"tensor cores: kernel pair {ms_tpu:.4f} ms")
    # the f32 route (CUDA cores) at the same shape, model contract
    q32, k32, v32 = (x.float() for x in (q, k, v))
    qf32, kf32, vf32 = (x.reshape(128, 2048, 128) for x in (q32, k32, v32))
    ms32 = cuda_ms(lambda: flash_mod.flash_prefill(qf32, kf32, vf32, lens,
                                                   acc, group=1, acc_group=1))
    plain32 = cuda_ms(lambda: ref.prefill_attention_ref(q32, k32, v32,
                                                        length=ln))
    lib32 = cuda_ms(lambda: F.scaled_dot_product_attention(
        q32, k32, v32, is_causal=True))
    t32, by32, _, nbytes32 = flash_bound(served, 32, 128, 4)
    print(f"  time served shape in f32, model contract, CUDA cores: kernel "
          f"pair {ms32:.4f} ms, plain {plain32:.4f} ms, bound {t32:.4f} ms "
          f"({by32}: at the 67 TF/s f32 peak; {nbytes32} B), kernel / bound "
          f"{ms32 / t32:.1f}x; F.scaled_dot_product_attention(is_causal="
          f"True) in f32, out only: {lib32:.4f} ms")
    del q32, k32, v32, qf32, kf32, vf32
    return out_err, {"bfloat16": (ms, plain, t, by, lib),
                     "extra": {"out_atol": FLASH_OUT_ATOL,
                               "acc_max_rel_err": acc_rel,
                               "acc_rtol": FLIP_ACC_RTOL,
                               "design": "bf16: tensor cores (mma.sync "
                                         "m16n8k16); f32: CUDA cores",
                               "tpu_contract_ms": ms_tpu,
                               "no_exact_rows_ms": ms_tc, **survey,
                               "f32_route_ms": ms32,
                               "f32_route_plain_ms": plain32,
                               "f32_route_bound_ms": t32,
                               "f32_route_library_ms": lib32}}


# ---------------------------------------------------------------------------
# phase 4 + 5: full-width longchat-7b
# ---------------------------------------------------------------------------


def served_prompts(vocab):
    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, vocab, LENS[i % len(LENS)]),
             NEW_TOKENS // (1 + i % 2)) for i in range(2 * LANES)]


# the plain prompt-attention versions, watched: a call on a CUDA tensor
# during a serve run would mean the prompt pass left the kernel
PLAIN_ON_CARD = {"prefill_attention_ref": 0, "flash_prefill_ref": 0}


def watch_plain_prompt_attention():
    for name in PLAIN_ON_CARD:
        fn = getattr(ref, name)

        def watched(q, *args, _fn=fn, _name=name, **kw):
            if q.is_cuda:
                PLAIN_ON_CARD[_name] += 1
            return _fn(q, *args, **kw)
        setattr(ref, name, watched)


def phase_serve(cfg, params, kv, smi, blocks, chunk=0):
    """Serve the 8 requests; every decode step must run one kernel per
    layer: ragged_decode with global selection, fused_decode with
    `blocks` > 1, and no other decode kernel; every prompt pass (a whole
    bucket, or one chunk with `chunk` > 0) one flash_prefill per layer,
    and no plain prompt attention on the card. Returns (decode kernel, its
    launches, flash_prefill launches, model, handles, loop)."""
    prune = baselines.unicaim(heavy=PROMPT_LEN // 2, reserve=64,
                              select_k=PROMPT_LEN // 16, select_blocks=blocks,
                              fused=True, kv_dtype=kv)
    kernel = "fused_decode" if blocks > 1 else "ragged_decode"
    model = Model(cfg, prune, device="cuda")
    loop = ServeLoop(model, params, lanes=LANES, max_new=NEW_TOKENS, block=8,
                     chunk_prefill=chunk, device="cuda")
    handles = [(loop.submit(Request(prompt=p, max_new=m)), m)
               for p, m in served_prompts(cfg.vocab_size)]
    torch.cuda.synchronize()
    reset_launches()
    for name in PLAIN_ON_CARD:
        PLAIN_ON_CARD[name] = 0
    t0 = time.monotonic()
    stats = loop.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    launches = counts.pop(kernel)
    flash = counts.pop("flash_prefill")
    c = loop.counters
    prompt_passes = c["chunk_dispatches"] if chunk else c["prefill_dispatches"]
    steps = c["decode_steps"]
    toks = sum(len(s.tokens) for s in stats)
    for s in stats:
        print(f"    req {s.rid}: lane={s.lane} prompt={s.prompt_len} "
              f"bucket={s.bucket} chunks={s.prefill_chunks} "
              f"new={len(s.tokens)} latency={s.latency:.3f}s "
              f"ttft={s.ttft:.3f}s")
    agg = loop.aggregate()
    print(f"  serve longchat-7b kv={kv} fused select_blocks={blocks} "
          f"chunk_prefill={chunk}: {len(stats)} requests on {LANES} lanes, "
          f"{toks} tokens in {wall:.3f}s = {toks / wall:.1f} tok/s, p50 TTFT "
          f"{agg['p50_ttft_s']:.3f}s; {steps} decode steps, "
          f"{c['prefill_dispatches']} prefills, {c['chunk_dispatches']} "
          f"chunk dispatches, {c['grouped_requests']} requests "
          f"group-admitted; {kernel} launches {launches} = {cfg.num_layers} "
          f"x {steps}: {launches == cfg.num_layers * steps}; flash_prefill "
          f"launches {flash} = {cfg.num_layers} x {prompt_passes}: "
          f"{flash == cfg.num_layers * prompt_passes}; plain prompt attention "
          f"on the card {PLAIN_ON_CARD}; other kernels {counts}  [{smi}]")
    assert all(h.done and len(h.tokens) == m for h, m in handles)
    assert c["nonfinite_lanes"] == 0
    assert launches == cfg.num_layers * steps and launches > 0
    assert flash == cfg.num_layers * prompt_passes and flash > 0
    assert not any(PLAIN_ON_CARD.values()), PLAIN_ON_CARD
    assert not any(counts.values()), counts
    if chunk:
        want = sum(math.ceil(len(p) / chunk)
                   for p, _ in served_prompts(cfg.vocab_size))
        assert c["chunk_dispatches"] == want, (c["chunk_dispatches"], want)
    return kernel, launches, flash, model, [h for h, _ in handles], agg


def phase_teacher(cfg, params, model, steps=16):
    """Where two greedy streams part: from one prefilled state the decode
    kernel's path and the composed plain path take the same tokens (the
    kernel path's greedy choices) for `steps` steps. Printed: the largest
    logit difference, how often the top-1 agrees (at least
    TEACHER_AGREE_MIN), and where it does not, the composed path's own gap
    between its top two logits (a near-tie that the two paths' summation
    orders may settle either way)."""
    prompts = served_prompts(cfg.vocab_size)[:LANES]
    padded = np.zeros((LANES, PROMPT_LEN), np.int64)
    for i, (p, _) in enumerate(prompts):
        padded[i, :len(p)] = p
    logits, st = model.prefill(params, {
        "tokens": torch.as_tensor(padded, device="cuda"),
        "length": torch.as_tensor([len(p) for p, _ in prompts],
                                  device="cuda")})
    composed = Model(cfg, dataclasses.replace(model.prune, fused=False),
                     device="cuda")
    st_c = DecodeState(kv=st.kv.clone())
    tok = torch.argmax(logits, -1)
    worst, agree, gaps = 0.0, 0, []
    for _ in range(steps):
        lk, st = model.decode_step(params, st, tok)
        lc, st_c = composed.decode_step(params, st_c, tok)
        worst = max(worst, float((lk - lc).abs().max()))
        ak, ac = torch.argmax(lk, -1), torch.argmax(lc, -1)
        agree += int((ak == ac).sum())
        top2 = torch.topk(lc, 2, dim=-1).values
        gaps += [round(float(x), 4) for x in (top2[:, 0] - top2[:, 1])[
            ak != ac]]
        tok = ak
    print(f"  teacher-forced kv={model.prune.kv_dtype} select_blocks="
          f"{model.prune.select_blocks}: {steps} steps x {LANES} lanes, the "
          f"same tokens into both paths: logits max|d| {worst:.3g}, top-1 "
          f"equal in {agree} of {steps * LANES}; the composed path's top-2 "
          f"gap where they differ: {sorted(gaps)}")
    assert math.isfinite(worst)
    assert agree >= TEACHER_AGREE_MIN, (agree, TEACHER_AGREE_MIN)


def phase_chunked(cfg, params, model, whole, chunked, chunk):
    """Chunked vs whole admission of the same requests: equal streams are
    counted (cuBLAS may pick other GEMM kernels for 512-row and longer
    products, so they are not asserted); per request, a whole-bucket
    prefill and a chunked one of its prompt must keep the same layer-0
    positions on at least KEPT_MIN of the slots and give first-token
    logits within PATH_ATOL."""
    same = sum(a.tokens == b.tokens for a, b in zip(whole, chunked))
    worst_kept, worst_logit = 1.0, 0.0
    for p, _ in served_prompts(cfg.vocab_size):
        t = len(p)
        bucket = bucket_length(t)
        padded = np.zeros(bucket, np.int64)
        padded[:t] = p
        length = torch.as_tensor([t], device="cuda")
        lw, sw = model.prefill_one(params, torch.as_tensor(padded), t)
        ps = model.init_prefill_chunk_state(1, bucket)
        n = math.ceil(t / chunk)
        for ci in range(n):
            x, ps = model.prefill_chunk(
                params, ps, torch.as_tensor(padded[None, ci * chunk:
                                                   (ci + 1) * chunk],
                                            device="cuda"),
                ci * chunk, length)
        lc, sc = model.prefill_finalize(params, ps, x, (n - 1) * chunk,
                                        length)
        pw, pc = sw.kv.pos[0, 0], sc.kv.pos[0, 0]          # [Hk, S]
        hits = sum(int(torch.isin(pw[h][pw[h] >= 0], pc[h][pc[h] >= 0]).sum())
                   for h in range(pw.shape[0]))
        agree = hits / int((pw >= 0).sum())
        worst_kept = min(worst_kept, agree)
        worst_logit = max(worst_logit, float((lc - lw[None]).abs().max()))
    print(f"  chunked (chunk_prefill={chunk}) vs whole admission: "
          f"{same} of {len(whole)} streams equal; per request, layer-0 kept "
          f"positions agree on >= {worst_kept:.4%} of slots (need "
          f"{KEPT_MIN:.0%}), first-token logits max|d| {worst_logit:.3g} "
          f"(atol {PATH_ATOL})")
    assert worst_kept >= KEPT_MIN and worst_logit <= PATH_ATOL


def three_pass_attend(cache, q, prune):
    """The composed decode step through the ops kernels, after the token
    write: approx_score over the mirror → group sum, selection bias and
    (block-local) top-k → gather → gather_attention. Returns out [B,Hq,dv]
    and the scores; in bf16 mode also checks approx_score_packed over the
    nibble-packed mirror (its 3-bit codes fit in 4) bit for bit."""
    b, hq, d = q.shape
    hk, s = cache.k.shape[1], cache.slots
    g, bh, dv = hq // hk, b * hk, cache.v.shape[-1]
    qq, qs = quant.quantize_query(q, prune.query_bits)
    mirror = (cache.kq if cache.kq is not None else cache.k).reshape(bh, s, d)
    sargs = (qq.reshape(bh, g, d), qs.reshape(bh, g), mirror,
             cache.kscale.reshape(bh, s),
             cache.valid.reshape(bh, s).to(torch.int8))
    scores = ops.approx_score(*sargs)                            # [BH,G,S]
    if cache.kq is not None:
        packed = approx_mod.approx_score_packed(
            sargs[0], sargs[1], quant.pack_int4(mirror), *sargs[3:])
        assert torch.equal(packed, scores), "packed scores differ"
    grouped = topk.gqa_group_scores(scores.reshape(b, hq, s), hk)
    biased = topk.apply_selection_bias(grouped, protected_mask(cache, prune),
                                       ~cache.valid)
    nb, sk = max(1, prune.select_blocks), prune.select_k
    _, idx = topk.exact_topk(biased.reshape(b, hk, nb, s // nb), sk // nb)
    idx = (idx + torch.arange(0, s, s // nb, device=q.device)[:, None]
           ).reshape(b, hk, sk)

    def rows(x):
        return torch.gather(x, 2, idx[..., None].expand(-1, -1, -1,
                                                        x.shape[-1]))

    k_sel, v_sel = rows(cache.k), rows(cache.v)
    if cache.quantized_kv:
        k_sel = k_sel.float() * torch.gather(cache.kscale, 2, idx)[..., None]
        v_sel = v_sel.float() * torch.gather(cache.vscale, 2, idx)[..., None]
    out = ops.gather_attention(q.reshape(bh, g, d), k_sel.reshape(bh, sk, d),
                               v_sel.reshape(bh, sk, dv),
                               torch.gather(cache.valid, 2, idx).reshape(
                                   bh, sk))
    return out.reshape(b, hq, dv)


def phase_paths(cfg, params, model):
    """One decode step from one prefilled state: the fused kernel and the
    three-pass step through the ops kernels vs the composed plain path.
    Returns the state, the next token and the launches of the three-pass
    step's kernels."""
    prompts = served_prompts(cfg.vocab_size)[:LANES]
    padded = np.zeros((len(prompts), PROMPT_LEN), np.int64)
    for i, (p, _) in enumerate(prompts):
        padded[i, :len(p)] = p
    lengths = [len(p) for p, _ in prompts]
    logits, st = model.prefill(params, {
        "tokens": torch.as_tensor(padded, device="cuda"),
        "length": torch.as_tensor(lengths, device="cuda")})
    assert torch.isfinite(logits).all()
    tok = torch.argmax(logits, -1)
    p0 = layer_params(params["seg0_dense"], 0)
    h = L.apply_norm(p0["ln1"], model._embed(params, tok), cfg.norm)
    cache0 = st.kv.layer(0)
    q, k, v = decode_qkv(p0["attn"], h, cfg, cache0)
    outs, accs = {}, {}
    for fused in (True, False):
        c = cache0.clone()
        prune = dataclasses.replace(model.prune, fused=fused)
        outs[fused] = decode_attention(c, q, k, v, prune)
        accs[fused] = c.acc
    c = cache0.clone()
    write_token(c, k, v, model.prune)
    torch.cuda.synchronize()
    reset_launches()
    three = three_pass_attend(c, q, model.prune)
    torch.cuda.synchronize()
    small = {n: x for n, x in launch_counts().items()
             if n not in ("ragged_decode", "fused_decode")}
    err = float((outs[True] - outs[False]).abs().max())
    err_acc = float((accs[True] - accs[False]).abs().max())
    err3 = float((three - outs[False]).abs().max())
    print(f"  paths kv={model.prune.kv_dtype} select_blocks="
          f"{model.prune.select_blocks}: layer-0 attention out, fused kernel "
          f"vs composed plain: max|d|={err:.3g} (atol {PATH_ATOL}); "
          f"accumulated scores max|d|={err_acc:.3g}; three-pass through "
          f"the ops kernels vs composed plain: max|d|={err3:.3g}, "
          f"launches {small}")
    assert torch.isfinite(outs[True]).all() and torch.isfinite(three).all()
    assert err <= PATH_ATOL and err_acc <= PATH_ATOL and err3 <= PATH_ATOL
    return st, tok, small


def phase_profile(params, model, st, tok, steps=4):
    """Where a decode step's time goes: host wall per step (no profiler),
    then the device time of the step's kernels under torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        nonlocal st, tok
        for _ in range(steps):
            logits, st = model.decode_step(params, st, tok)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()

    run()                                                # warm
    t0 = time.monotonic()
    run()
    wall = (time.monotonic() - t0) / steps * 1e3         # ms per step
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3 / steps    # ms per step
    launches = sum(e.count for e in kernels) / steps
    share = "not measured" if busy == 0 else f"{busy / wall:.1%} busy"
    print(f"  profile kv={model.prune.kv_dtype} select_blocks="
          f"{model.prune.select_blocks} B={LANES}: decode step "
          f"{wall:.2f} ms host wall, {busy:.2f} ms of kernel time ({share}),"
          f" {launches:.0f} kernel launches per step")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3 / steps:8.3f} ms/step  "
              f"x{e.count // steps:<5d} {e.key[:80]}")


def phase_prefill_profile(cfg, params, model):
    """Where one whole-prompt prefill dispatch (4 x 2048, the served
    prompts) spends its time: host wall (no profiler), then the device time
    of its kernels under torch.profiler and the flash_prefill pair's
    share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    prompts = served_prompts(cfg.vocab_size)[:LANES]
    padded = np.zeros((LANES, PROMPT_LEN), np.int64)
    for i, (p, _) in enumerate(prompts):
        padded[i, :len(p)] = p
    batch = {"tokens": torch.as_tensor(padded, device="cuda"),
             "length": torch.as_tensor([len(p) for p, _ in prompts],
                                       device="cuda")}

    def run():
        model.prefill(params, batch)
        torch.cuda.synchronize()

    run()                                                # warm
    t0 = time.monotonic()
    run()
    wall = (time.monotonic() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    flash = sum(dev_us(e) for e in kernels
                if "flash_prefill" in e.key or "fold_columns" in e.key) / 1e3
    launches = sum(e.count for e in kernels)
    share = ("not measured" if busy == 0 else
             f"{busy / wall:.1%} busy, flash_prefill pair {flash:.2f} ms = "
             f"{flash / busy:.1%} of the kernel time")
    print(f"  profile prompt pass kv={model.prune.kv_dtype} B={LANES} "
          f"N={PROMPT_LEN}: {wall:.2f} ms host wall, {busy:.2f} ms of kernel "
          f"time ({share}), {launches} kernel launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:6]:
        print(f"    {dev_us(e) / 1e3:8.3f} ms  x{e.count:<5d} {e.key[:80]}")


def main():
    t_all = time.monotonic()
    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    cap = torch.cuda.get_device_capability(0)
    if cap < (9, 0):
        raise SystemExit(f"chip_smoke: compute capability {cap} < 9.0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    print(f"[device] {torch.cuda.get_device_name(0)} sm_{cap[0]}{cap[1]} "
          f"x{torch.cuda.device_count()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}; f32 matmuls in full f32 (TF32 off)")
    print(smi)

    # 2. build
    t = time.monotonic()
    secs = build.build_all(verbose=True)
    print(f"[build] {secs} ({time.monotonic() - t:.1f}s wall)")
    compiled = prompt_kernel_report()
    decode_compiled = decode_kernel_report()

    # 3. kernels
    worst, timings = {}, {}
    for name, phase in (("ragged_decode", phase_ragged),
                        ("fused_decode", phase_fused),
                        ("approx_score", phase_approx),
                        ("gather_attention", phase_gather),
                        ("flash_prefill", phase_flash)):
        t = time.monotonic()
        print(f"[kernels] {name} vs plain (out atol {OUT_ATOL}, probs atol "
              f"{PROBS_ATOL}; gather_attention atol {GATHER_ATOL}; "
              "approx_score bit for bit; flash_prefill out atol "
              f"{FLASH_OUT_ATOL}, acc rtol {FLASH_ACC_RTOL} with f32 "
              f"probabilities, {FLIP_ACC_RTOL:.4g} with bf16-rounded ones)")
        worst[name], timings[name] = phase()
        print(f"[kernels] {name} done in {time.monotonic() - t:.1f}s")
    timings["flash_prefill"]["extra"].update(compiled)
    for name in ("ragged_decode", "fused_decode"):
        warm, wall = timings[name]["bfloat16 warm"]
        timings[name]["extra"] = {
            "ms_l2_warm": warm, "call_ms": wall,
            "int8": dict(zip(("ms", "plain_ms", "bound_ms"),
                             timings[name]["int8"][:3]),
                         ms_l2_warm=timings[name]["int8 warm"][0]),
            **decode_compiled.get(name, {})}

    # 4 + 5. full-width longchat-7b, global then block-local selection
    t = time.monotonic()
    cfg = get_config("longchat-7b")
    init_model = Model(cfg, baselines.unicaim(heavy=1024, reserve=64,
                                              select_k=128), device="cuda")
    params = init_model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[serve] longchat-7b random bf16 weights: {n_params} params, "
          f"made on the card in {time.monotonic() - t:.1f}s")
    watch_plain_prompt_attention()
    launches = dict.fromkeys(launch_counts(), 0)
    for blocks in (1, 4):
        for kv in ("bf16", "int8"):
            tag = f"kv={kv} select_blocks={blocks}"
            t = time.monotonic()
            kernel, n, flash, model, whole, _ = phase_serve(cfg, params, kv,
                                                            smi, blocks)
            launches[kernel] += n
            launches["flash_prefill"] += flash
            print(f"[serve] {tag} phase {time.monotonic() - t:.1f}s")
            if blocks == 1 and kv == "bf16":
                t = time.monotonic()
                phase_teacher(cfg, params, model)
                print(f"[serve] {tag} teacher-forced phase "
                      f"{time.monotonic() - t:.1f}s")
                t = time.monotonic()
                _, n, flash, cmodel, sliced, _ = phase_serve(
                    cfg, params, kv, smi, blocks, chunk=CHUNK)
                launches["ragged_decode"] += n
                launches["flash_prefill"] += flash
                phase_chunked(cfg, params, cmodel, whole, sliced, CHUNK)
                del cmodel
                print(f"[serve] {tag} chunk_prefill={CHUNK} phase "
                      f"{time.monotonic() - t:.1f}s")
                t = time.monotonic()
                phase_prefill_profile(cfg, params, model)
                print(f"[profile] prompt pass phase "
                      f"{time.monotonic() - t:.1f}s")
            t = time.monotonic()
            st, tok, small = phase_paths(cfg, params, model)
            for name, n in small.items():
                launches[name] += n
            print(f"[paths] {tag} phase {time.monotonic() - t:.1f}s")
            t = time.monotonic()
            phase_profile(params, model, st, tok)
            del st, model
            print(f"[profile] {tag} phase {time.monotonic() - t:.1f}s")
    assert all(launches.values()), launches

    rows = [  # name, source, TPU entry it replaces, timing key, error key
        ("ragged_decode", "ragged_decode.cu", "ragged_decode.py:167",
         "bfloat16", "ragged_decode"),
        ("fused_decode", "fused_decode.cu", "fused_decode.py:173",
         "bfloat16", "fused_decode"),
        ("approx_score", "approx_score.cu", "approx_score.py:96",
         "approx_score", "approx_score"),
        ("approx_score_packed", "approx_score.cu", "approx_score.py:67",
         "approx_score_packed", "approx_score"),
        ("gather_attention", "gather_attention.cu", "gather_attention.py:59",
         "gather_attention", "gather_attention"),
        ("flash_prefill", "flash_prefill.cu", "flash_prefill.py:105",
         "bfloat16", "flash_prefill"),
    ]
    table = []
    for name, src, tpu, key, err in rows:
        phase = "approx_score" if name.startswith("approx") else name
        ms, plain, t_bound, by, lib = timings[phase][key]
        table.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": launches[name], "max_abs_err": worst[err], "ms": ms,
            "plain_ms": plain, "bound_ms": t_bound, "bound_by": by,
            "library_ms": lib, **timings[phase].get("extra", {})})
    print(json.dumps({"kernels": table}))
    print(f"[done] {time.monotonic() - t_all:.1f}s total")
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


if __name__ == "__main__":
    main()
