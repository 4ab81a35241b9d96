"""Hopper kernel for fill-aware fused pruned decode, and its wrapper.

Replaces the TPU kernel `ragged_decode` of the reference package
(`src/repro/kernels/ragged_decode.py:167`, body `_ragged_decode_kernel`);
the CUDA source is `csrc/ragged_decode.cu`, whose header note gives the
design and the memory bound. Its plain PyTorch version is
`kernels/ref.fused_decode_ref`.

  fills  [BH]        int32    live slot count per row (lane fill)
  q      [BH, G, d]  float    exact queries
  qq     [BH, G, d]  int8     quantized queries
  qscale [BH, G]     f32
  mirror [BH, S, d]  int8     key mirror (int8-KV mode: K itself)
  mscale [BH, S]     f32
  kscale [BH, S]     f32      K-row dequant scale (ones for bf16)
  vscale [BH, S]     f32
  valid  [BH, S]     int8
  prot   [BH, S]     int8     protected slots always win the race
  k      [BH, S, d]  f32 | bf16 | int8
  v      [BH, S, dv] same dtype as k
  → out [BH, G, dv] f32, probs [BH, S] f32

Two routes compute it. The single-CTA row (`decode_row`) keeps a row's
[G][S] scores and keys in one CTA's shared memory; the wrapper takes it
wherever that layout fits the card (`long_route`, on the kernel's own
`*_smem_bytes` query), which is every served shape. At any larger S
(decode_32k's 32,768 slots, long_500k's 524,288) it takes the long route
(`csrc/decode_long.cuh`): a grid of score CTAs, then a
cluster of CTAs a row that races and attends over a device scratch the
wrapper allocates for the call. Both are hand-written kernels; neither
falls back to the other or to the plain version.

`LAUNCHES["ragged_decode"]` counts the single-CTA route's launches,
`LAUNCHES["ragged_decode_long"]` the long route's.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

LAUNCHES = {"ragged_decode": 0, "ragged_decode_long": 0}
BLOCK_S = 64                 # slots per live block (the skip granularity)
KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_GROUPS = 16              # query rows per kv-head (kMaxG in the source)
_P = ctypes.c_void_p
_I = ctypes.c_int
_Z = ctypes.c_size_t


def _bind(lib):
    fn = lib.ragged_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([_I, _I] + [_P] * 15 + [_I] * 7
                       + [ctypes.c_float, _P])
        fn.restype = _I
        lib.ragged_decode_smem_bytes.argtypes = [_I] * 6
        lib.ragged_decode_smem_bytes.restype = _Z
        lib.ragged_decode_long_smem_bytes.argtypes = [_I] * 7
        lib.ragged_decode_long_smem_bytes.restype = _Z
        lib.ragged_decode_long_scratch_bytes.argtypes = [_I] * 4
        lib.ragged_decode_long_scratch_bytes.restype = _Z
    return lib


def long_route(short_smem: int, dev: torch.device) -> bool:
    """Whether a call takes the long route: the single-CTA row needs
    `short_smem` bytes of shared memory (the kernel's own query, `layout`
    in csrc/decode_common.cuh), more than one block of `dev` may opt
    into."""
    return short_smem > build.smem_limit(dev)


def check_groups(kernel: str, g: int) -> None:
    """Raise on G query rows per kv-head outside [1, MAX_GROUPS]: the
    decode, score and gather kernels size per-row arrays by kMaxG."""
    if not 1 <= g <= MAX_GROUPS:
        raise ValueError(f"{kernel}: G={g} query rows per kv-head outside "
                         f"the kernels' [1, {MAX_GROUPS}]")


def granule(nbytes: int) -> int:
    """The widest copy (16, 8 or 4 bytes; 1 = bytewise) that tiles rows of
    `nbytes`: the width at which the kernels copy K and V rows."""
    return next((w for w in (16, 8, 4) if nbytes % w == 0), 1)


def decode_spec(q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot,
                k, v, select_k: int, kernel: str):
    """Check the eleven decode inputs shared by `ragged_decode` and
    `fused_decode` → (q as f32, the inputs in launch order, (BH, S, G, d,
    dv)). Raises on G above the kernels' limit (first, whatever the
    device), on a tensor that is not contiguous on the CUDA card, on a
    shape or dtype the kernels do not take, on select_k outside [1, S], and
    on qq, the mirror, K or V not starting aligned to the kernels' copies
    of it (4 bytes for qq; 16 for the mirror when d % 16 == 0, else 4;
    `granule` of a row's bytes for K and V). Nothing here depends on S
    beyond select_k <= S: every S has a route."""
    bh, g, d = q.shape
    check_groups(kernel, g)
    s = mirror.shape[1]
    dv = v.shape[-1]
    dev = q.device
    q = q.to(torch.float32).contiguous()       # [BH, G, d]: small
    i8, f32 = torch.int8, torch.float32
    spec = {"q": (q, (bh, g, d), f32),
            "qq": (qq, (bh, g, d), i8), "qscale": (qscale, (bh, g), f32),
            "mirror": (mirror, (bh, s, d), i8), "mscale": (mscale, (bh, s), f32),
            "kscale": (kscale, (bh, s), f32), "vscale": (vscale, (bh, s), f32),
            "valid": (valid, (bh, s), i8), "prot": (prot, (bh, s), i8),
            "k": (k, (bh, s, d), k.dtype), "v": (v, (bh, s, dv), k.dtype)}
    build.check_tensors(kernel, spec, dev)
    if k.dtype not in KV_KIND:
        raise TypeError(f"K/V dtype {k.dtype} not in {list(KV_KIND)}")
    if not 1 <= select_k <= s:
        raise ValueError(f"select_k={select_k} outside [1, S={s}]")
    if d % 4:
        raise ValueError(f"{kernel}: head_dim {d} is not a multiple of 4")
    build.check_copy_aligned(
        kernel, qq=(qq, 4), mirror=(mirror, 16 if d % 16 == 0 else 4),
        k=(k, granule(d * k.element_size())),
        v=(v, granule(dv * v.element_size())))
    return q, [t for t, _, _ in spec.values()], (bh, s, g, d, dv)


def ragged_decode(fills, q, qq, qscale, mirror, mscale, kscale, vscale,
                  valid, prot, k, v, *, select_k: int):
    """Launch the kernel on the current stream → (out, probs), by the
    single-CTA route where its layout fits the card, else by the long
    route (`long_route`). Raises on a tensor that is not on the CUDA card
    or not contiguous, on a shape or dtype the kernel does not take, and
    when the launch fails; only q is converted (to f32)."""
    q, ins, (bh, s, g, d, dv) = decode_spec(
        q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot, k, v,
        select_k, "ragged_decode")
    dev = q.device
    build.check_tensors("ragged_decode",
                        {"fills": (fills, (bh,), torch.int32)}, dev)
    lib = _bind(build.load("ragged_decode"))
    long = long_route(lib.ragged_decode_smem_bytes(
        s, g, d, dv, select_k, KV_KIND[k.dtype]), dev)
    out = torch.empty((bh, g, dv), dtype=torch.float32, device=dev)
    probs = torch.empty((bh, s), dtype=torch.float32, device=dev)
    # the long route's scratch, on the current stream (the caching
    # allocator's blocks start 512-byte aligned)
    scratch = torch.empty(lib.ragged_decode_long_scratch_bytes(
        bh, s, g, select_k), dtype=torch.uint8, device=dev) if long else None
    with torch.cuda.device(dev):
        rc = lib.ragged_decode_launch(
            int(long), KV_KIND[k.dtype], fills.data_ptr(),
            *(t.data_ptr() for t in ins), out.data_ptr(), probs.data_ptr(),
            scratch.data_ptr() if long else None, bh, s, g, d, dv,
            select_k, BLOCK_S, ctypes.c_float(1.0 / math.sqrt(d)),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("ragged_decode", rc)
    LAUNCHES["ragged_decode_long" if long else "ragged_decode"] += 1
    return out, probs
