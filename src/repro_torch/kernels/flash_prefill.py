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
order instead of the tensor cores (the source note says why). MLA's
absorbed prompt pass (d = 576 over the latent, dv = 512: `LATENT`) takes
a third kernel, `flash_prefill_latent_kernel`: bf16, the model's contract,
one CTA per (q-head, 64-row q-block) with both products on warpgroup
`wgmma`; its V is the view of K's first dv columns, which the kernel reads
from the latent tiles it loads for K, so nothing is copied.

  q       [BH, C, d]        f32 | bf16   queries of absolute rows
                                         [row0, row0 + C)
  k       [BH/group, N, d]  q's dtype    N >= row0 + C
  v       [BH/group, N, dv] q's dtype    dv = d, or LATENT
  lengths [BH]              int32        true prompt length per q-head row
  acc     [BH/acc_group, N] f32          column sums, added into IN PLACE
  → out   [BH, C, dv]       f32 (model contract) | q's dtype (TPU contract)

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
LATENT = (576, 512)          # MLA's (d, dv): kv_lora + qk_rope, kv_lora
KV_KIND = {torch.float32: 0, torch.bfloat16: 1}
# rows with a denominator l below this (a probability above 1/32) take
# exact logits on the bf16 route, model contract; chip_smoke.py sets it to
# 0 for a moment to time and check the tensor-core logits alone
EXACT_BELOW = 32.0
# the latent route's sweep 2 makes an exact row's logits exactly where its
# probability may reach this, and takes the tensor cores' elsewhere (p below
# it: a bf16 flip moves out by at most 2^-13 |v|); 0 makes all of them
# exactly, as the tc route does. chip_smoke.py sets it to 0 for a moment to
# measure the rule's error
EXACT_P = 1.0 / 32
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    fn = lib.flash_prefill_launch
    if fn.argtypes is None:
        fn.argtypes = [_I, _I] + [_P] * 7 + [_I] * 11 \
            + [ctypes.c_float] * 3 + [_P]
        fn.restype = _I
        lib.flash_prefill_smem_bytes.argtypes = [_I, _I, _I]
        lib.flash_prefill_smem_bytes.restype = ctypes.c_size_t
    return lib


def check_latent_v(v, k, shape, dtype, dev,
                   kernel: str = "flash_prefill") -> int:
    """The latent route's V ([G, N, dv]): `shape` and `dtype` on `dev`, and
    the view of K's ([G, N, d]) first dv columns (the kernel reads V from
    the latent tiles it loads for K). Returns its row stride in elements,
    K's row width."""
    if (tuple(v.shape) != tuple(shape) or v.dtype != dtype
            or v.device != dev):
        raise ValueError(f"{kernel}: v is {tuple(v.shape)} {v.dtype} "
                         f"on {v.device}, expected {tuple(shape)} {dtype} "
                         f"on {dev}")
    n, d = k.shape[1], k.shape[2]
    if v.data_ptr() != k.data_ptr() or v.stride(1) != d or v.stride(2) != 1 \
            or (shape[0] > 1 and v.stride(0) != n * d):
        raise ValueError(f"{kernel}: the latent route reads V from K's "
                         "rows: v must be the view k[..., :dv]")
    return d


def flash_prefill(q, k, v, lengths, acc, *, group: int, acc_group: int,
                  row0: int = 0, obs_window: int = 0, model: bool = True,
                  scale: float = None):
    """Launch the kernel pair on the current stream → out [BH, C, dv].

    `model=True` is the model's contract: probabilities rounded to V's
    dtype (when that is bf16), out in f32, the `acc_group` q-head rows of
    each acc row summed. `model=False` is the TPU contract: f32
    probabilities, out in q's dtype (`acc_group` must be 1). bf16 inputs
    run on the tensor cores, f32 inputs on the CUDA cores; (d, dv) =
    `LATENT` runs the latent route, bf16 and the model's contract only.
    Raises on a tensor that is not contiguous on the CUDA card (the latent
    route's v: that is not the view k[..., :dv]), on a bf16 tensor that
    does not start 16-byte aligned (the route's cp.async copies), on a
    shape or dtype the kernel does not take, and when the launch fails."""
    bh, c, d = q.shape
    n, dv = k.shape[1], v.shape[-1]
    dev = q.device
    latent = (d, dv) == LATENT
    build.check_tensors("flash_prefill", {
        "q": (q, (bh, c, d), q.dtype),
        "k": (k, (bh // group, n, d), q.dtype),
        "lengths": (lengths, (bh,), torch.int32),
        "acc": (acc, (bh // acc_group, n), torch.float32)}, dev)
    if not latent:
        build.check_tensors("flash_prefill",
                            {"v": (v, (bh // group, n, dv), q.dtype)}, dev)
    if q.dtype not in KV_KIND:
        raise TypeError(f"flash_prefill: dtype {q.dtype} not in "
                        f"{list(KV_KIND)}")
    if bh % group or bh % acc_group or (not model and acc_group != 1):
        raise ValueError(f"flash_prefill: BH={bh} with group={group}, "
                         f"acc_group={acc_group}")
    if latent and (q.dtype != torch.bfloat16 or not model):
        raise ValueError(f"flash_prefill: the latent route (d, dv) = "
                         f"{LATENT} takes bf16 under the model's contract")
    v_ld = (check_latent_v(v, k, (bh // group, n, dv), q.dtype, dev)
            if latent else dv)
    if not latent and (d % 16 or d > MAX_D or dv != d):
        raise ValueError(f"flash_prefill: head dims (d, dv) = ({d}, {dv}): "
                         f"d must be a multiple of 16 up to {MAX_D} with "
                         f"dv = d, or (d, dv) = {LATENT}")
    if row0 < 0 or row0 + c > n:
        raise ValueError(f"flash_prefill: rows [{row0}, {row0 + c}) outside "
                         f"the {n}-row K/V buffer")
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16
                                         for t in (q, k, v)):
        raise ValueError("flash_prefill: bf16 q, k and v must start "
                         "16-byte aligned")
    lib = _bind(build.load("flash_prefill"))
    build.check_smem("flash_prefill",
                     lib.flash_prefill_smem_bytes(KV_KIND[q.dtype], d, dv),
                     dev, f"head dims ({d}, {dv})")
    out = torch.empty((bh, c, dv), dtype=torch.float32 if model else q.dtype,
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
            acc.data_ptr(), bh, c, n, d, dv, v_ld, group, acc_group, row0,
            obs_window, round_p, ctypes.c_float(scale),
            ctypes.c_float(EXACT_BELOW), ctypes.c_float(EXACT_P),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("flash_prefill", rc)
    LAUNCHES["flash_prefill"] += 1
    return out
