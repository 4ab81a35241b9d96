"""Hopper kernel for fused pruned decode with a block-local CAM race, and
its wrapper.

Replaces the TPU kernel `fused_decode` of the reference package
(`src/repro/kernels/fused_decode.py:173`, body `_fused_decode_kernel`);
the CUDA source is `csrc/fused_decode.cu`, whose header note gives the
design and the memory bound. Its plain PyTorch version is
`kernels/ref.fused_decode_ref(num_blocks=...)`. Shapes as in
`kernels/ragged_decode.py`, without `fills`: every slot is scored, and
each of the `num_blocks` equal slot blocks races for
select_k / num_blocks winners. Two routes, picked as in
`kernels/ragged_decode.py` (`long_route`): the single-CTA row where its
layout fits, the long route (whose race cluster takes the selection
blocks one after another) at any larger S.

On a cache whose slots are split over as many ranks as there are
selection blocks, the blocked race runs on each rank's block as one
block: `ragged_decode.ShardStages` (ragged_decode's library, every slot
of the block scored), driven by `kernels/ops.sharded_decode`, whose
collectives merge the ranks' partials.

`LAUNCHES["fused_decode"]` counts the single-CTA route's launches,
`LAUNCHES["fused_decode_long"]` the long route's and
`LAUNCHES["fused_decode_shard"]` the sharded route's (one a call).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ragged_decode import (KV_KIND, decode_spec,
                                                 long_route)

LAUNCHES = {"fused_decode": 0, "fused_decode_long": 0,
            "fused_decode_shard": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int
_Z = ctypes.c_size_t


def _bind(lib):
    fn = lib.fused_decode_launch
    if fn.argtypes is None:
        fn.argtypes = [_I, _I] + [_P] * 14 + [_I] * 7 + [ctypes.c_float, _P]
        fn.restype = _I
        lib.fused_decode_smem_bytes.argtypes = [_I] * 7
        lib.fused_decode_smem_bytes.restype = _Z
        lib.fused_decode_long_smem_bytes.argtypes = [_I] * 8
        lib.fused_decode_long_smem_bytes.restype = _Z
        lib.fused_decode_long_scratch_bytes.argtypes = [_I] * 5
        lib.fused_decode_long_scratch_bytes.restype = _Z
    return lib


def fused_decode(q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot,
                 k, v, *, select_k: int, num_blocks: int = 1):
    """Launch the kernel on the current stream → (out [BH,G,dv] f32,
    probs [BH,S] f32), by the single-CTA route where its layout fits the
    card, else by the long route (`ragged_decode.long_route`). S and
    select_k must divide into `num_blocks` equal blocks
    (`kernels/ops.fused_decode` pads a ragged tail). Raises on a tensor
    that is not on the CUDA card or not contiguous, on a shape or dtype
    the kernel does not take, and when the launch fails; only q is
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
    long = long_route(lib.fused_decode_smem_bytes(
        s, g, d, dv, select_k, nb, KV_KIND[k.dtype]), dev)
    out = torch.empty((bh, g, dv), dtype=torch.float32, device=dev)
    probs = torch.empty((bh, s), dtype=torch.float32, device=dev)
    scratch = torch.empty(lib.fused_decode_long_scratch_bytes(
        bh, s, g, select_k, nb), dtype=torch.uint8,
        device=dev) if long else None
    with torch.cuda.device(dev):
        rc = lib.fused_decode_launch(
            int(long), KV_KIND[k.dtype], *(t.data_ptr() for t in ins),
            out.data_ptr(), probs.data_ptr(),
            scratch.data_ptr() if long else None, bh, s, g, d, dv, select_k,
            nb, ctypes.c_float(1.0 / math.sqrt(d)),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("fused_decode", rc)
    LAUNCHES["fused_decode_long" if long else "fused_decode"] += 1
    return out, probs
