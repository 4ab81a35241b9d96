#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order (no failure is caught: any one exits non-zero):
  1. device  — a CUDA card of compute capability >= 9.0, its name and
               power limit (nvidia-smi);
  2. build   — every kernel of the port, built from the sources in this
               checkout (nvcc, one process per source);
  3. kernels — each kernel against its plain PyTorch version on the card,
               at longchat-7b and granite-like (GQA) decode shapes, bf16
               and int8 K/V, with CUDA-event times beside the reckoned
               bound (and, for gather_attention, beside the one PyTorch
               call that computes its function);
  4. serve   — full-width longchat-7b (random bf16 weights from a seed)
               serving 8 requests on 4 lanes through `ServeLoop`, bf16 and
               int8 KV, first with global selection (the ragged_decode
               kernel), then with select_blocks = 4 (the fused_decode
               kernel); each path's kernel must launch 32 x its decode
               steps and the other decode kernel never;
  5. paths   — one decode step from one prefilled state, fused kernel vs
               the composed plain path, layer-0 attention outputs and
               accumulated scores compared; with global selection also the
               three-pass step through the ops kernels (approx_score, int4
               approx_score_packed, top-k, gather_attention); then a few
               decode steps under torch.profiler: host wall per step
               against the device time of its kernels.

Every launch count is reset just before the path it counts and read just
after. The second-to-last line is a JSON object describing every kernel;
the last is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""
from __future__ import annotations

import dataclasses
import json
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
from repro_torch.kernels import fused_decode as fused_mod  # noqa: E402
from repro_torch.kernels import gather_attention as gather_mod  # noqa: E402
from repro_torch.kernels import build, ops, ref  # noqa: E402
from repro_torch.kernels import ragged_decode as ragged_mod  # noqa: E402
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.attention_layer import decode_qkv  # noqa: E402
from repro_torch.models.transformer import Model, layer_params  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM datasheet peak rates
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
OUT_ATOL, PROBS_ATOL = 1e-3, 1e-5  # f32 on both sides, other sum order
GATHER_ATOL = 1e-4                 # f32 on both sides, other sum order
PATH_ATOL = 1e-2                   # bf16 activations
COUNTERS = (ragged_mod.LAUNCHES, fused_mod.LAUNCHES, approx_mod.LAUNCHES,
            gather_mod.LAUNCHES)
SEED = 0
# the CLI's --prompt-len 2048 --new-tokens 32 --serve workload
PROMPT_LEN, NEW_TOKENS, LANES = 2048, 32, 4
LENS = (PROMPT_LEN, PROMPT_LEN // 2, PROMPT_LEN - 7, PROMPT_LEN // 3)


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


def bound(nbytes, int8_ops=0.0, f32_flops=0.0):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over their peak rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = int8_ops / INT8_OPS_PER_S + f32_flops / F32_FLOPS_PER_S
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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
    ]
    worst = 0.0
    for ci, (name, bh, g, d, s, k) in enumerate(cases):
        for kv in (torch.bfloat16, torch.int8):
            fills, args = kernel_inputs(bh, g, d, s, mixed_fills(bh, s, k, ci),
                                        kv, seed=ci)
            out, probs = ragged_mod.ragged_decode(fills, *args, select_k=k)
            torch.cuda.synchronize()
            out_r, probs_r = ref.fused_decode_ref(*args, select_k=k)
            e_out = float((out - out_r).abs().max())
            e_probs = float((probs - probs_r).abs().max())
            free = fills == 0
            print(f"  {name} G={g} d={d} k={k} {str(kv)[6:]}: "
                  f"max|dout|={e_out:.3g} max|dprobs|={e_probs:.3g} "
                  f"free-lane out/probs all zero="
                  f"{not out[free].any() and not probs[free].any()}")
            assert e_out <= OUT_ATOL, (name, kv, e_out)
            assert e_probs <= PROBS_ATOL, (name, kv, e_probs)
            assert torch.isfinite(out).all() and torch.isfinite(probs).all()
            assert not out[free].any() and not probs[free].any()
            worst = max(worst, e_out, e_probs)

    timings = {}
    for kv in (torch.bfloat16, torch.int8):
        fills, args = kernel_inputs(128, 1, 128, 1088, MAIN_FILLS, kv, seed=9)
        ms = cuda_ms(lambda: ragged_mod.ragged_decode(fills, *args,
                                                      select_k=128))
        plain = cuda_ms(lambda: ref.fused_decode_ref(*args, select_k=128))
        t, by, nbytes = ragged_bound(fills, args, 128)
        timings[str(kv)[6:]] = (ms, plain, t, by, None)
        print(f"  time main shape (BH=128 G=1 d=128 S=1088 k=128 "
              f"{str(kv)[6:]}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {t:.4f} ms ({by}: {nbytes} B at 3.35 TB/s); "
              "library call: none (no single PyTorch call computes this "
              "function)")
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
    """fused_decode against its plain version: nb in {2, 4, 8} directly,
    and nb = 3 (1088 = 3 x 362 + 2: a ragged tail) through ops; timed at
    the served shape with nb = 4."""
    cases = [  # name, BH, G, d, S, select_k
        ("longchat S=1088", 4 * 32, 1, 128, 1088, 128),
        ("granite-like GQA S=1088", 4 * 8, 4, 64, 1088, 128),
    ]
    worst = 0.0
    for ci, (name, bh, g, d, s, k) in enumerate(cases):
        for kv in (torch.bfloat16, torch.int8):
            fills, args = kernel_inputs(bh, g, d, s, mixed_fills(bh, s, k, ci),
                                        kv, seed=10 + ci)
            free = fills == 0
            for nb in (2, 4, 8, 3):
                if nb == 3:      # select_k divisible by 3, S padded by ops
                    kk = k - k % 3
                    out, probs = ops.fused_decode(*args, select_k=kk,
                                                  num_blocks=nb)
                    pad = [F.pad(a, [0, 0] * (a.dim() - 2) + [0, 1])
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
                print(f"  {name} G={g} d={d} k={kk} nb={nb} {str(kv)[6:]}: "
                      f"max|dout|={e_out:.3g} max|dprobs|={e_probs:.3g}")
                assert e_out <= OUT_ATOL, (name, kv, nb, e_out)
                assert e_probs <= PROBS_ATOL, (name, kv, nb, e_probs)
                assert torch.isfinite(out).all() and torch.isfinite(probs).all()
                assert not out[free].any() and not probs[free].any()
                worst = max(worst, e_out, e_probs)
    timings = {}
    for kv in (torch.bfloat16, torch.int8):
        _, args = kernel_inputs(128, 1, 128, 1088, MAIN_FILLS, kv, seed=9)
        ms = cuda_ms(lambda: fused_mod.fused_decode(*args, select_k=128,
                                                    num_blocks=4))
        plain = cuda_ms(lambda: ref.fused_decode_ref(*args, select_k=128,
                                                     num_blocks=4))
        t, by, nbytes = fused_bound(args, 128, 4)
        timings[str(kv)[6:]] = (ms, plain, t, by, None)
        print(f"  time main shape (BH=128 G=1 d=128 S=1088 k=128 nb=4 "
              f"{str(kv)[6:]}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {t:.4f} ms ({by}: {nbytes} B at 3.35 TB/s); library "
              "call: none (no single PyTorch call scores, races and "
              "attends)")
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


# ---------------------------------------------------------------------------
# phase 4 + 5: full-width longchat-7b
# ---------------------------------------------------------------------------


def served_prompts(vocab):
    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, vocab, LENS[i % len(LENS)]),
             NEW_TOKENS // (1 + i % 2)) for i in range(2 * LANES)]


def phase_serve(cfg, params, kv, smi, blocks):
    """Serve the 8 requests; every decode step must run one kernel per
    layer: ragged_decode with global selection, fused_decode with
    `blocks` > 1, and no other kernel of the port."""
    prune = baselines.unicaim(heavy=PROMPT_LEN // 2, reserve=64,
                              select_k=PROMPT_LEN // 16, select_blocks=blocks,
                              fused=True, kv_dtype=kv)
    kernel = "fused_decode" if blocks > 1 else "ragged_decode"
    model = Model(cfg, prune, device="cuda")
    loop = ServeLoop(model, params, lanes=LANES, max_new=NEW_TOKENS, block=8,
                     device="cuda")
    handles = [(loop.submit(Request(prompt=p, max_new=m)), m)
               for p, m in served_prompts(cfg.vocab_size)]
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.monotonic()
    stats = loop.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    counts = launch_counts()
    launches = counts.pop(kernel)
    steps = loop.counters["decode_steps"]
    toks = sum(len(s.tokens) for s in stats)
    for s in stats:
        print(f"    req {s.rid}: lane={s.lane} prompt={s.prompt_len} "
              f"bucket={s.bucket} new={len(s.tokens)} "
              f"latency={s.latency:.3f}s ttft={s.ttft:.3f}s")
    print(f"  serve longchat-7b kv={kv} fused select_blocks={blocks}: "
          f"{len(stats)} requests on {LANES} lanes, {toks} tokens in "
          f"{wall:.3f}s = {toks / wall:.1f} tok/s; {steps} decode steps, "
          f"{loop.counters['prefill_dispatches']} prefills, "
          f"{loop.counters['grouped_requests']} requests group-admitted; "
          f"{kernel} launches {launches} = {cfg.num_layers} x {steps}: "
          f"{launches == cfg.num_layers * steps}; other kernels {counts}  "
          f"[{smi}]")
    assert all(h.done and len(h.tokens) == m for h, m in handles)
    assert loop.counters["nonfinite_lanes"] == 0
    assert launches == cfg.num_layers * steps and launches > 0
    assert not any(counts.values()), counts
    return kernel, launches, model


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

    # 3. kernels
    worst, timings = {}, {}
    for name, phase in (("ragged_decode", phase_ragged),
                        ("fused_decode", phase_fused),
                        ("approx_score", phase_approx),
                        ("gather_attention", phase_gather)):
        t = time.monotonic()
        print(f"[kernels] {name} vs plain (out atol {OUT_ATOL}, probs atol "
              f"{PROBS_ATOL}; gather_attention atol {GATHER_ATOL}; "
              "approx_score bit for bit)")
        worst[name], timings[name] = phase()
        print(f"[kernels] {name} done in {time.monotonic() - t:.1f}s")

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
    launches = dict.fromkeys(launch_counts(), 0)
    for blocks in (1, 4):
        for kv in ("bf16", "int8"):
            tag = f"kv={kv} select_blocks={blocks}"
            t = time.monotonic()
            kernel, n, model = phase_serve(cfg, params, kv, smi, blocks)
            launches[kernel] += n
            print(f"[serve] {tag} phase {time.monotonic() - t:.1f}s")
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
            "library_ms": lib})
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
