"""Hopper kernel for CAM-mode approximate scoring, over an int8 key mirror
or an int4 one packed two codes to a byte, and its wrappers.

Replaces the TPU kernels `approx_score` (`src/repro/kernels/
approx_score.py:96`) and `approx_score_packed` (`:67`) of the reference
package; the CUDA source is `csrc/approx_score.cu`, whose header note gives
the design and the memory bound. Plain PyTorch versions:
`kernels/ref.approx_score_ref` and `ref.approx_score_packed_ref`, which
the kernel equals bit for bit.

  qq        [BH, G, d]    int8     quantized queries
  qscale    [BH, G]       f32
  kq        [BH, S, d]    int8     key mirror
  kq_packed [BH, S, d/2]  uint8    the same, nibble-packed (quant.pack_int4)
  kscale    [BH, S]       f32
  valid     [BH, S]       int8
  → scores [BH, G, S] f32, NEG_INF at invalid slots

`LAUNCHES["approx_score"]` and `LAUNCHES["approx_score_packed"]` count the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = {"approx_score": 0, "approx_score_packed": 0}
MAX_GROUPS, MAX_GROUP_DIM = 8, 4096   # kMaxG, kMaxGD in the source
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    fn = lib.approx_score_launch
    if fn.argtypes is None:
        fn.argtypes = [_I] + [_P] * 6 + [_I] * 4 + [_P]
        fn.restype = _I
    return lib


def _launch(name, qq, qscale, kq, kscale, valid, packed: bool):
    bh, g, d = qq.shape
    s = kq.shape[1]
    dev = qq.device
    width = d // 2 if packed else d
    kdt = torch.uint8 if packed else torch.int8
    build.check_tensors(name, {
        "qq": (qq, (bh, g, d), torch.int8),
        "qscale": (qscale, (bh, g), torch.float32),
        "kq": (kq, (bh, s, width), kdt),
        "kscale": (kscale, (bh, s), torch.float32),
        "valid": (valid, (bh, s), torch.int8)}, dev)
    if d % 8:
        raise ValueError(f"{name}: head_dim {d} is not a multiple of 8")
    if g > MAX_GROUPS or g * d > MAX_GROUP_DIM:
        raise ValueError(f"{name}: G={g} x d={d} exceeds the kernel's "
                         f"{MAX_GROUPS} rows and {MAX_GROUP_DIM} codes")
    build.check_aligned(name, qq, kq)
    lib = _bind(build.load("approx_score"))
    out = torch.empty((bh, g, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.approx_score_launch(
            int(packed), qq.data_ptr(), qscale.data_ptr(), kq.data_ptr(),
            kscale.data_ptr(), valid.data_ptr(), out.data_ptr(), bh, s, g, d,
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch(name, rc)
    LAUNCHES[name] += 1
    return out


def approx_score(qq, qscale, kq, kscale, valid):
    """CAM scores over the int8 mirror → [BH, G, S] f32 (see the module
    note). Raises on a tensor that is not contiguous on the CUDA card, on a
    shape or dtype the kernel does not take, on d % 8 != 0, and when the
    launch fails."""
    return _launch("approx_score", qq, qscale, kq, kscale, valid, False)


def approx_score_packed(qq, qscale, kq_packed, kscale, valid):
    """CAM scores over the nibble-packed int4 mirror → [BH, G, S] f32."""
    return _launch("approx_score_packed", qq, qscale, kq_packed, kscale,
                   valid, True)
