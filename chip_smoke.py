#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA Hopper card.

    python3 chip_smoke.py

Phases, in order (no failure is caught: any one exits non-zero):
  1. device  — a CUDA card of compute capability >= 9.0, its name and
               power limit (nvidia-smi);
  2. build   — every kernel of the port, built from the sources in this
               checkout (nvcc, one process per source);
  3. kernels — each kernel against its plain PyTorch version on the card,
               at longchat-7b and granite-like (GQA) decode shapes, with
               CUDA-event times beside the reckoned memory bound;
  4. serve   — full-width longchat-7b (random bf16 weights from a seed)
               serving 8 requests on 4 lanes through `ServeLoop` with the
               fused kernel path, bf16 and int8 KV; the kernel's launch
               count must be 32 x the decode steps run;
  5. paths   — one decode step from one prefilled state, fused kernel vs
               the composed plain path, layer-0 attention outputs compared;
               then a few decode steps under torch.profiler: host wall per
               step against the device time of its kernels.

The second-to-last line is a JSON object describing every kernel; the last
is {"ok": true, "device": {...}}. Imports nothing of JAX.
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

from repro_torch.configs.base import get_config  # noqa: E402
from repro_torch.core import baselines  # noqa: E402
from repro_torch.core.attention import decode_attention  # noqa: E402
from repro_torch.kernels import build, ref  # noqa: E402
from repro_torch.kernels.ragged_decode import (LAUNCHES,  # noqa: E402
                                               ragged_decode)
from repro_torch.launch.serve import Request, ServeLoop  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models.attention_layer import decode_qkv  # noqa: E402
from repro_torch.models.transformer import Model, layer_params  # noqa: E402

HBM_BYTES_PER_S = 3.35e12          # H100 SXM datasheet peak rates
INT8_OPS_PER_S = 1979e12
F32_FLOPS_PER_S = 67e12
OUT_ATOL, PROBS_ATOL = 1e-3, 1e-5  # f32 on both sides, other sum order
PATH_ATOL = 1e-2                   # bf16 activations
SEED = 0
# the CLI's --prompt-len 2048 --new-tokens 32 --serve workload
PROMPT_LEN, NEW_TOKENS, LANES = 2048, 32, 4
LENS = (PROMPT_LEN, PROMPT_LEN // 2, PROMPT_LEN - 7, PROMPT_LEN // 3)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


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
# phase 3: ragged_decode against its plain version
# ---------------------------------------------------------------------------


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
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = (float((2 * g * d * live).sum()) / INT8_OPS_PER_S
             + float((2 * g * wins * (d + dv)).sum()) / F32_FLOPS_PER_S)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes", nbytes
    return t_ops * 1e3, "operations", nbytes


def mixed_fills(bh, s, k, seed):
    """0 (a free lane), below select_k, not a multiple of the block, full,
    then random."""
    head = [0, k - 5, 333 if s > 333 else s - 3, s]
    rest = np.random.default_rng(seed).integers(1, s + 1, bh - len(head))
    return head + rest.tolist()


def phase_kernels():
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
            out, probs = ragged_decode(fills, *args, select_k=k)
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

    # timing at the main path's shape: 4 lanes x 32 heads, S=1088,
    # select_k=128, fills as the served prompts leave them (1024 kept,
    # +decode; the 682-token prompt keeps all 682)
    timings = {}
    lane_fills = (1040, 1030, 1050, 690)
    fills_main = [f for f in lane_fills for _ in range(32)]
    for kv in (torch.bfloat16, torch.int8):
        fills, args = kernel_inputs(128, 1, 128, 1088, fills_main, kv, seed=9)
        ms = cuda_ms(lambda: ragged_decode(fills, *args, select_k=128))
        plain = cuda_ms(lambda: ref.fused_decode_ref(*args, select_k=128))
        bound, by, nbytes = ragged_bound(fills, args, 128)
        timings[str(kv)[6:]] = (ms, plain, bound, by)
        print(f"  time main shape (BH=128 G=1 d=128 S=1088 k=128 "
              f"{str(kv)[6:]}): kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"bound {bound:.4f} ms ({by}: {nbytes} B at 3.35 TB/s); "
              "library call: none (no single PyTorch call computes this "
              "function)")
    return worst, timings


# ---------------------------------------------------------------------------
# phase 4 + 5: full-width longchat-7b
# ---------------------------------------------------------------------------


def served_prompts(vocab):
    rng = np.random.default_rng(SEED)
    return [(rng.integers(0, vocab, LENS[i % len(LENS)]),
             NEW_TOKENS // (1 + i % 2)) for i in range(2 * LANES)]


def phase_serve(cfg, params, kv, smi):
    prune = baselines.unicaim(heavy=PROMPT_LEN // 2, reserve=64,
                              select_k=PROMPT_LEN // 16, fused=True,
                              kv_dtype=kv)
    model = Model(cfg, prune, device="cuda")
    loop = ServeLoop(model, params, lanes=LANES, max_new=NEW_TOKENS, block=8,
                     device="cuda")
    handles = [(loop.submit(Request(prompt=p, max_new=m)), m)
               for p, m in served_prompts(cfg.vocab_size)]
    LAUNCHES["ragged_decode"] = 0
    torch.cuda.synchronize()
    t0 = time.monotonic()
    stats = loop.run()
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches = LAUNCHES["ragged_decode"]
    steps = loop.counters["decode_steps"]
    toks = sum(len(s.tokens) for s in stats)
    for s in stats:
        print(f"    req {s.rid}: lane={s.lane} prompt={s.prompt_len} "
              f"bucket={s.bucket} new={len(s.tokens)} "
              f"latency={s.latency:.3f}s ttft={s.ttft:.3f}s")
    print(f"  serve longchat-7b kv={kv} fused: {len(stats)} requests on "
          f"{LANES} lanes, {toks} tokens in {wall:.3f}s = "
          f"{toks / wall:.1f} tok/s; {steps} decode steps, "
          f"{loop.counters['prefill_dispatches']} prefills, "
          f"{loop.counters['grouped_requests']} requests group-admitted; "
          f"ragged_decode launches {launches} = {cfg.num_layers} x {steps}: "
          f"{launches == cfg.num_layers * steps}  [{smi}]")
    assert all(h.done and len(h.tokens) == m for h, m in handles)
    assert loop.counters["nonfinite_lanes"] == 0
    assert launches == cfg.num_layers * steps and launches > 0
    return launches, toks / wall, model


def phase_paths(cfg, params, model):
    """One decode step from one prefilled state: fused kernel vs composed."""
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
    torch.cuda.synchronize()
    err = float((outs[True] - outs[False]).abs().max())
    err_acc = float((accs[True] - accs[False]).abs().max())
    print(f"  paths kv={model.prune.kv_dtype}: layer-0 attention out, fused "
          f"kernel vs composed plain: max|d|={err:.3g} (atol {PATH_ATOL}); "
          f"accumulated scores max|d|={err_acc:.3g}")
    assert torch.isfinite(outs[True]).all()
    assert err <= PATH_ATOL and err_acc <= PATH_ATOL
    return st, tok


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
    print(f"  profile kv={model.prune.kv_dtype} B={LANES}: decode step "
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
    t = time.monotonic()
    print("[kernels] ragged_decode vs plain (out atol "
          f"{OUT_ATOL}, probs atol {PROBS_ATOL})")
    worst, timings = phase_kernels()
    print(f"[kernels] done in {time.monotonic() - t:.1f}s")

    # 4 + 5. full-width longchat-7b
    t = time.monotonic()
    cfg = get_config("longchat-7b")
    init_model = Model(cfg, baselines.unicaim(heavy=1024, reserve=64,
                                              select_k=128), device="cuda")
    params = init_model.init(SEED)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"[serve] longchat-7b random bf16 weights: {n_params} params, "
          f"made on the card in {time.monotonic() - t:.1f}s")
    launches = 0
    for kv in ("bf16", "int8"):
        t = time.monotonic()
        n, _, model = phase_serve(cfg, params, kv, smi)
        launches += n
        print(f"[serve] kv={kv} phase {time.monotonic() - t:.1f}s")
        t = time.monotonic()
        st, tok = phase_paths(cfg, params, model)
        print(f"[paths] kv={kv} phase {time.monotonic() - t:.1f}s")
        t = time.monotonic()
        phase_profile(params, model, st, tok)
        del st
        print(f"[profile] kv={kv} phase {time.monotonic() - t:.1f}s")

    ms, plain, bound, by = timings["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "ragged_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ragged_decode.cu",
        "replaces": "src/repro/kernels/ragged_decode.py:167",
        "launches": launches, "max_abs_err": worst, "ms": ms,
        "plain_ms": plain, "bound_ms": bound, "bound_by": by,
        "library_ms": None}]}))
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
