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
_KV_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    fn = lib.ragged_decode_launch
    if fn.argtypes is None:
        fn.argtypes = ([_I] + [_P] * 14 + [_I] * 7
                       + [ctypes.c_float, _P])
        fn.restype = _I
        lib.ragged_decode_smem_bytes.argtypes = [_I] * 4
        lib.ragged_decode_smem_bytes.restype = ctypes.c_size_t
        lib.ragged_decode_max_groups.argtypes = []
        lib.ragged_decode_max_groups.restype = _I
    return lib


def smem_limit(device: torch.device) -> int:
    props = torch.cuda.get_device_properties(device)
    return int(getattr(props, "shared_memory_per_block_optin", 232448))


def ragged_decode(fills, q, qq, qscale, mirror, mscale, kscale, vscale,
                  valid, prot, k, v, *, select_k: int):
    """Launch the kernel on the current stream → (out, probs). Raises on a
    tensor that is not on the CUDA card or not contiguous, on a shape or
    dtype the kernel does not take, and when the launch fails; only q is
    converted (to f32)."""
    bh, g, d = q.shape
    s = mirror.shape[1]
    dv = v.shape[-1]
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"ragged_decode runs on a CUDA tensor, got {dev}")
    q = q.to(torch.float32).contiguous()       # [BH, G, d]: small
    i8, f32 = torch.int8, torch.float32
    spec = {"fills": (fills, (bh,), torch.int32), "q": (q, (bh, g, d), f32),
            "qq": (qq, (bh, g, d), i8), "qscale": (qscale, (bh, g), f32),
            "mirror": (mirror, (bh, s, d), i8), "mscale": (mscale, (bh, s), f32),
            "kscale": (kscale, (bh, s), f32), "vscale": (vscale, (bh, s), f32),
            "valid": (valid, (bh, s), i8), "prot": (prot, (bh, s), i8),
            "k": (k, (bh, s, d), k.dtype), "v": (v, (bh, s, dv), k.dtype)}
    for name, (t, shp, dt) in spec.items():
        if tuple(t.shape) != shp or t.dtype != dt:
            raise ValueError(f"{name}: {tuple(t.shape)} {t.dtype}, expected "
                             f"{shp} {dt}")
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {dev}")
    if k.dtype not in _KV_KIND:
        raise TypeError(f"K/V dtype {k.dtype} not in {list(_KV_KIND)}")
    if not 1 <= select_k <= s:
        raise ValueError(f"select_k={select_k} outside [1, S={s}]")
    if d % 4 or qq.data_ptr() % 4 or mirror.data_ptr() % 4:
        raise ValueError("int8 rows must be 4-byte aligned (head_dim % 4 == 0)"
                         " for dp4a")
    lib = _bind(build.load("ragged_decode"))
    if g > lib.ragged_decode_max_groups():
        raise ValueError(f"G={g} query rows per kv-head exceeds the "
                         f"kernel's {lib.ragged_decode_max_groups()}")
    smem = lib.ragged_decode_smem_bytes(s, g, d, select_k)
    if smem > smem_limit(dev):
        raise ValueError(
            f"ragged_decode: S={s} slots x G={g} need {smem} bytes of shared "
            f"memory per CTA, above the card's {smem_limit(dev)}; large-slot "
            "decode needs a global score scratch (not ported yet)")
    ins = [t for t, _, _ in spec.values()]
    out = torch.empty((bh, g, dv), dtype=torch.float32, device=dev)
    probs = torch.empty((bh, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.ragged_decode_launch(
            _KV_KIND[k.dtype], *(t.data_ptr() for t in ins), out.data_ptr(),
            probs.data_ptr(), bh, s, g, d, dv, select_k, BLOCK_S,
            ctypes.c_float(1.0 / math.sqrt(d)), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_decode launch failed: CUDA error {rc}")
    LAUNCHES["ragged_decode"] += 1
    return out, probs
