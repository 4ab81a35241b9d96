"""Hopper kernel for fused pruned decode with a block-local CAM race, and
its wrapper.

Replaces the TPU kernel `fused_decode` of the reference package
(`src/repro/kernels/fused_decode.py:173`, body `_fused_decode_kernel`);
the CUDA source is `csrc/fused_decode.cu`, whose header note gives the
design and the memory bound. Its plain PyTorch version is
`kernels/ref.fused_decode_ref(num_blocks=...)`. Shapes as in
`kernels/ragged_decode.py`, without `fills`: every slot is scored, and
each of the `num_blocks` equal slot blocks races for
select_k / num_blocks winners.

`LAUNCHES["fused_decode"]` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ragged_decode import KV_KIND, SMEM_WHAT, decode_spec

LAUNCHES = {"fused_decode": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    fn = lib.fused_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [_I] + [_P] * 13 + [_I] * 7 + [ctypes.c_float, _P]
        fn.restype = _I
        lib.fused_decode_smem_bytes.argtypes = [_I] * 7
        lib.fused_decode_smem_bytes.restype = ctypes.c_size_t
    return lib


def fused_decode(q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot,
                 k, v, *, select_k: int, num_blocks: int = 1):
    """Launch the kernel on the current stream → (out [BH,G,dv] f32,
    probs [BH,S] f32). S and select_k must divide into `num_blocks` equal
    blocks (`kernels/ops.fused_decode` pads a ragged tail). Raises on a
    tensor that is not on the CUDA card or not contiguous, on a shape or
    dtype the kernel does not take, and when the launch fails; only q is
    converted (to f32)."""
    q, ins, (bh, s, g, d, dv) = decode_spec(
        q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot, k, v,
        select_k, "fused_decode")
    nb = num_blocks
    if nb < 1 or s % nb or select_k % nb:
        raise ValueError(f"fused_decode: S={s} and select_k={select_k} must "
                         f"divide into num_blocks={nb} equal blocks")
    dev = q.device
    lib = _bind(build.load("fused_decode"))
    build.check_smem("fused_decode",
                     lib.fused_decode_smem_bytes(s, g, d, dv, select_k, nb,
                                                 KV_KIND[k.dtype]), dev,
                     SMEM_WHAT.format(s=s, g=g))
    out = torch.empty((bh, g, dv), dtype=torch.float32, device=dev)
    probs = torch.empty((bh, s), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.fused_decode_launch(
            KV_KIND[k.dtype], *(t.data_ptr() for t in ins), out.data_ptr(),
            probs.data_ptr(), bh, s, g, d, dv, select_k, nb,
            ctypes.c_float(1.0 / math.sqrt(d)),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("fused_decode", rc)
    LAUNCHES["fused_decode"] += 1
    return out, probs
