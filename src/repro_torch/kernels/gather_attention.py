"""Hopper kernel for exact softmax attention over gathered slots, and its
wrapper.

Replaces the TPU kernel `gather_attention` of the reference package
(`src/repro/kernels/gather_attention.py:59`, body `_gather_attn_kernel`);
the CUDA source is `csrc/gather_attention.cu`, whose header note gives the
design and the memory bound. Its plain PyTorch version is
`kernels/ref.gather_attention_ref`.

  q     [BH, G, d]   float    query group of one kv-head
  k     [BH, K, d]   f32 | bf16 | int8   gathered keys
  v     [BH, K, dv]  same dtype as k     gathered values
  valid [BH, K]      int8
  → out [BH, G, dv] f32

`LAUNCHES["gather_attention"]` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ragged_decode import KV_KIND, MAX_GROUPS

LAUNCHES = {"gather_attention": 0}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    fn = lib.gather_attention_launch
    if fn.argtypes is None:
        fn.argtypes = [_I] + [_P] * 5 + [_I] * 5 + [ctypes.c_float, _P]
        fn.restype = _I
        lib.gather_attention_smem_bytes.argtypes = [_I] * 3
        lib.gather_attention_smem_bytes.restype = ctypes.c_size_t
    return lib


def gather_attention(q, k, v, valid):
    """Launch the kernel on the current stream → out [BH, G, dv] f32.
    Raises on a tensor that is not contiguous on the CUDA card, on a shape
    or dtype the kernel does not take, when the logits do not fit in shared
    memory, and when the launch fails; only q is converted (to f32)."""
    bh, g, d = q.shape
    kk, dv = v.shape[1], v.shape[-1]
    dev = q.device
    q = q.to(torch.float32).contiguous()
    build.check_tensors("gather_attention", {
        "q": (q, (bh, g, d), torch.float32),
        "k": (k, (bh, kk, d), k.dtype), "v": (v, (bh, kk, dv), k.dtype),
        "valid": (valid, (bh, kk), torch.int8)}, dev)
    if k.dtype not in KV_KIND:
        raise TypeError(f"K/V dtype {k.dtype} not in {list(KV_KIND)}")
    if g > MAX_GROUPS:
        raise ValueError(f"gather_attention: G={g} exceeds {MAX_GROUPS}")
    lib = _bind(build.load("gather_attention"))
    build.check_smem("gather_attention",
                     lib.gather_attention_smem_bytes(kk, g, d), dev,
                     f"K={kk} x G={g}")
    out = torch.empty((bh, g, dv), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.gather_attention_launch(
            KV_KIND[k.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
            valid.data_ptr(), out.data_ptr(), bh, kk, g, d, dv,
            ctypes.c_float(1.0 / math.sqrt(d)),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("gather_attention", rc)
    LAUNCHES["gather_attention"] += 1
    return out
