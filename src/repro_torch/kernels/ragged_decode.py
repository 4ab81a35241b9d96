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

`LAUNCHES["ragged_decode"]` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

LAUNCHES = {"ragged_decode": 0}
BLOCK_S = 64                 # slots per live block (the skip granularity)
KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
MAX_GROUPS = 8               # query rows per kv-head (kMaxG in the source)
SMEM_WHAT = ("S={s} slots x G={g} (large-slot decode needs a global score "
             "scratch, not ported yet)")
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    fn = lib.ragged_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([_I] + [_P] * 14 + [_I] * 7
                       + [ctypes.c_float, _P])
        fn.restype = _I
        lib.ragged_decode_smem_bytes.argtypes = [_I] * 6
        lib.ragged_decode_smem_bytes.restype = ctypes.c_size_t
    return lib


def granule(nbytes: int) -> int:
    """The widest copy (16, 8 or 4 bytes; 1 = bytewise) that tiles rows of
    `nbytes`: the width at which the kernels copy K and V rows."""
    return next((w for w in (16, 8, 4) if nbytes % w == 0), 1)


def decode_spec(q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot,
                k, v, select_k: int, kernel: str):
    """Check the eleven decode inputs shared by `ragged_decode` and
    `fused_decode` → (q as f32, the inputs in launch order, (BH, S, G, d,
    dv)). Raises on a tensor that is not contiguous on the CUDA card, on a
    shape or dtype the kernels do not take, on select_k outside [1, S], on
    G above the kernels' limit, and on qq, the mirror, K or V not starting
    aligned to the kernels' copies of it (4 bytes for qq; 16 for the mirror
    when d % 16 == 0, else 4; `granule` of a row's bytes for K and V)."""
    bh, g, d = q.shape
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
    if g > MAX_GROUPS:
        raise ValueError(f"G={g} query rows per kv-head exceeds the "
                         f"kernels' {MAX_GROUPS}")
    return q, [t for t, _, _ in spec.values()], (bh, s, g, d, dv)


def ragged_decode(fills, q, qq, qscale, mirror, mscale, kscale, vscale,
                  valid, prot, k, v, *, select_k: int):
    """Launch the kernel on the current stream → (out, probs). Raises on a
    tensor that is not on the CUDA card or not contiguous, on a shape or
    dtype the kernel does not take, and when the launch fails; only q is
    converted (to f32)."""
    q, ins, (bh, s, g, d, dv) = decode_spec(
        q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot, k, v,
        select_k, "ragged_decode")
    dev = q.device
    build.check_tensors("ragged_decode",
                        {"fills": (fills, (bh,), torch.int32)}, dev)
    lib = _bind(build.load("ragged_decode"))
    build.check_smem("ragged_decode",
                     lib.ragged_decode_smem_bytes(s, g, d, dv, select_k,
                                                  KV_KIND[k.dtype]), dev,
                     SMEM_WHAT.format(s=s, g=g))
    out = torch.empty((bh, g, dv), dtype=torch.float32, device=dev)
    probs = torch.empty((bh, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.ragged_decode_launch(
            KV_KIND[k.dtype], fills.data_ptr(),
            *(t.data_ptr() for t in ins), out.data_ptr(),
            probs.data_ptr(), bh, s, g, d, dv, select_k, BLOCK_S,
            ctypes.c_float(1.0 / math.sqrt(d)),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("ragged_decode", rc)
    LAUNCHES["ragged_decode"] += 1
    return out, probs
