"""Hopper kernel for causal prompt attention with accumulated column sums,
and its wrapper.

Replaces the TPU kernel `flash_prefill` of the reference package
(`src/repro/kernels/flash_prefill.py:105`, body `_flash_prefill_kernel`);
the CUDA source is `csrc/flash_prefill.cu`, whose header note gives the
design and the bound. Two routes, by dtype: bf16 inputs run on the tensor
cores (`flash_prefill_tc_kernel`, mma.sync), f32 inputs on the CUDA cores
(`flash_prefill_f32_kernel`). One launch runs the route's attention kernel
and the fold of its column partials into `acc`. Its plain PyTorch versions
are `kernels/ref.flash_prefill_ref` (the TPU contract) and
`kernels/ref.prefill_attention_ref` (the model's contract). On the bf16
route under the model's contract, the rows whose softmax denominator is
below `EXACT_BELOW` take their logits from f32 FMAs in the plain version's
order instead of the tensor cores (the source note says why).

  q       [BH, C, d]        f32 | bf16   queries of absolute rows
                                         [row0, row0 + C)
  k, v    [BH/group, N, d]  q's dtype    N >= row0 + C
  lengths [BH]              int32        true prompt length per q-head row
  acc     [BH/acc_group, N] f32          column sums, added into IN PLACE
  → out   [BH, C, d]        f32 (model contract) | q's dtype (TPU contract)

`LAUNCHES["flash_prefill"]` counts the launches (one per call: the
attention kernel and its fold together).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

LAUNCHES = {"flash_prefill": 0}
BLOCK_Q = 64                 # query rows per CTA (kBQ in the source)
BLOCK_K = 64                 # key columns per tile (kBK)
MAX_D = 128
KV_KIND = {torch.float32: 0, torch.bfloat16: 1}
# rows with a denominator l below this (a probability above 1/32) take
# exact logits on the bf16 route, model contract; chip_smoke.py sets it to
# 0 for a moment to time and check the tensor-core logits alone
EXACT_BELOW = 32.0
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    fn = lib.flash_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = [_I, _I] + [_P] * 7 + [_I] * 9 + [ctypes.c_float] * 2 \
            + [_P]
        fn.restype = _I
        lib.flash_prefill_smem_bytes.argtypes = [_I, _I]
        lib.flash_prefill_smem_bytes.restype = ctypes.c_size_t
    return lib


def flash_prefill(q, k, v, lengths, acc, *, group: int, acc_group: int,
                  row0: int = 0, obs_window: int = 0, model: bool = True,
                  scale: float = None):
    """Launch the kernel pair on the current stream → out [BH, C, d].

    `model=True` is the model's contract: probabilities rounded to V's
    dtype (when that is bf16), out in f32, the `acc_group` q-head rows of
    each acc row summed. `model=False` is the TPU contract: f32
    probabilities, out in q's dtype (`acc_group` must be 1). bf16 inputs
    run on the tensor cores, f32 inputs on the CUDA cores. Raises on a
    tensor that is not contiguous on the CUDA card, on a bf16 tensor that
    does not start 16-byte aligned (the route's cp.async copies), on a
    shape or dtype the kernel does not take, and when the launch fails."""
    bh, c, d = q.shape
    n = k.shape[1]
    dev = q.device
    build.check_tensors("flash_prefill", {
        "q": (q, (bh, c, d), q.dtype),
        "k": (k, (bh // group, n, d), q.dtype),
        "v": (v, (bh // group, n, d), q.dtype),
        "lengths": (lengths, (bh,), torch.int32),
        "acc": (acc, (bh // acc_group, n), torch.float32)}, dev)
    if q.dtype not in KV_KIND:
        raise TypeError(f"flash_prefill: dtype {q.dtype} not in "
                        f"{list(KV_KIND)}")
    if bh % group or bh % acc_group or (not model and acc_group != 1):
        raise ValueError(f"flash_prefill: BH={bh} with group={group}, "
                         f"acc_group={acc_group}")
    if d % 16 or d > MAX_D:
        raise ValueError(f"flash_prefill: head dim {d} must be a multiple "
                         f"of 16 up to {MAX_D}")
    if row0 < 0 or row0 + c > n:
        raise ValueError(f"flash_prefill: rows [{row0}, {row0 + c}) outside "
                         f"the {n}-row K/V buffer")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_prefill: bf16 q, k and v must start "
                         "16-byte aligned")
    lib = _bind(build.load("flash_prefill"))
    build.check_smem("flash_prefill",
                     lib.flash_prefill_smem_bytes(KV_KIND[q.dtype], d), dev,
                     f"head dim {d}")
    out = torch.empty((bh, c, d), dtype=torch.float32 if model else q.dtype,
                      device=dev)
    part = torch.empty((bh, math.ceil(c / BLOCK_Q), n), dtype=torch.float32,
                       device=dev)
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    round_p = int(model and v.dtype == torch.bfloat16)
    with torch.cuda.device(dev):
        rc = lib.flash_prefill_launch(
            KV_KIND[q.dtype], int(not model), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), lengths.data_ptr(), out.data_ptr(), part.data_ptr(),
            acc.data_ptr(), bh, c, n, d, group, acc_group, row0, obs_window,
            round_p, ctypes.c_float(scale), ctypes.c_float(EXACT_BELOW),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("flash_prefill", rc)
    LAUNCHES["flash_prefill"] += 1
    return out
