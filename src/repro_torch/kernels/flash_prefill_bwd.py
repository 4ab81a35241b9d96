"""Hopper kernel for the backward of causal prompt attention, and its
wrapper.

Replaces no TPU kernel: the reference trains through plain XLA autodiff of
`chunked_causal_attention` (`src/repro/core/attention.py:490`, under
`jax.value_and_grad` at `src/repro/launch/train.py:95`), while the port's
causal attention on the card is the `flash_prefill` kernel, which has no
gradient. The CUDA source is `csrc/flash_prefill_bwd.cu`, whose header
note gives the function, the design and the bound: on bf16 inputs every
product is a warpgroup product (wgmma) on the tensor cores, with dS, and
an f32 dout, split into bf16 hi and lo halves (a bf16 dout is taken as it
is); on f32 inputs f32 FMAs on the CUDA cores. MLA's latent shape ((d, dv)
= `LATENT`: 128 q-heads over one latent, V the view of its first 512
columns) takes a route of its own, bf16 only, which returns the latent's
whole gradient du = dk + [dv, 0] in place of dk and dv (K and V are one
tensor): `split_dout_kernel` (an f32 dout split once into bf16 hi and lo
in a scratch tensor), `bwd_dq_latent_kernel`, `bwd_du_latent_kernel` (du
of each slice of q-heads into one f32 partial) and `sum_slices_kernel`
(the slices added in order), which read V from the latent rows they load
for K, so nothing is copied. Its plain PyTorch version is
`kernels/ref.flash_prefill_bwd_ref` (du: its dk + [dv, 0]);
`kernels/ops.causal_attention` is the differentiable op that runs it.

  q    [B, Hq, N, d]   f32 | bf16
  k    [B, Hk, N, d]   q's dtype     Hq a multiple of Hk
  v    [B, Hk, N, dv]  q's dtype     dv = d, or the view k[..., :dv]
                                     at (d, dv) = LATENT, Hk = 1
  dout [B, Hq, N, dv]  f32, or bf16 with bf16 q: the cotangent of out
  → (dq [B, Hq, N, d], dk [B, Hk, N, d], dv [B, Hk, N, dv]) in q's dtype;
    at LATENT (dq, du [B, 1, N, d], None), du the gradient of the latent
    through K and through V

`LAUNCHES["flash_prefill_bwd"]` counts the calls: one per backward, the
kernels it runs together (either route).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_prefill import LATENT, check_latent_v

LAUNCHES = {"flash_prefill_bwd": 0}
KIND = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128
_P = ctypes.c_void_p
_I = ctypes.c_int


def _bind(lib):
    fn = lib.flash_prefill_bwd_launch
    if fn.argtypes is None:
        fn.argtypes = [_I] * 2 + [_P] * 8 + [_I] * 5 + [ctypes.c_float, _P]
        fn.restype = _I
        lib.flash_prefill_bwd_smem_bytes.argtypes = [_I]
        lib.flash_prefill_bwd_smem_bytes.restype = ctypes.c_size_t
        lat = lib.flash_prefill_bwd_latent_launch
        lat.argtypes = [_I] + [_P] * 8 + [_I] * 4 + [ctypes.c_float, _P]
        lat.restype = _I
        split = lib.flash_prefill_bwd_split_launch
        split.argtypes = [_P, _P, ctypes.c_size_t, _P]
        split.restype = _I
        lib.flash_prefill_bwd_latent_smem_bytes.argtypes = []
        lib.flash_prefill_bwd_latent_smem_bytes.restype = ctypes.c_size_t
    return lib


def latent_slices(hq: int) -> int:
    """The slices of q-heads whose du the latent route sums apart (then
    adds in order): q-heads of at most 16 a slice, so the du kernel has 8
    CTAs a key block at deepseek-v3's 128 heads."""
    return hq // max(h for h in range(1, min(hq, 16) + 1) if hq % h == 0)


def _latent(q, k, v, dout, scale):
    """The latent route: q [B,Hq,N,576] bf16, k the latent [B,1,N,576] bf16,
    v the view k[..., :512], dout [B,Hq,N,512] f32 or bf16 → (dq, du,
    None)."""
    b, hq, n, d = q.shape
    dv_dim = v.shape[-1]
    dev = q.device
    if q.dtype != torch.bfloat16:
        raise TypeError(f"flash_prefill_bwd: the latent route (d, dv) = "
                        f"{LATENT} takes bf16 q, k and v, got {q.dtype}")
    if k.shape[1] != 1:
        raise ValueError(f"flash_prefill_bwd: the latent route takes one "
                         f"latent (Hk = 1), got Hk = {k.shape[1]}")
    build.check_tensors("flash_prefill_bwd", {
        "q": (q, (b, hq, n, d), q.dtype), "k": (k, (b, 1, n, d), q.dtype),
        "dout": (dout, (b, hq, n, dv_dim), dout.dtype)}, dev)
    check_latent_v(v.reshape(b, n, dv_dim), k.reshape(b, n, d),
                   (b, n, dv_dim), q.dtype, dev, "flash_prefill_bwd")
    build.check_copy_aligned("flash_prefill_bwd", q=(q, 16), k=(k, 16),
                             dout=(dout, 16))
    lib = _bind(build.load("flash_prefill_bwd"))
    build.check_smem("flash_prefill_bwd",
                     lib.flash_prefill_bwd_latent_smem_bytes(), dev,
                     f"head dims {LATENT}")
    slices = latent_slices(hq)
    dq = torch.empty_like(q)
    du = torch.empty((b, 1, n, d), dtype=q.dtype, device=dev)
    stats = torch.empty((3, b * hq, n), dtype=torch.float32, device=dev)
    part = torch.empty((slices, b, n, d), dtype=torch.float32, device=dev)
    # an f32 dout's bf16 hi and lo halves (2 x 2 bytes an element)
    split = (torch.empty((2, b, hq, n, dv_dim), dtype=torch.bfloat16,
                         device=dev) if dout.dtype == torch.float32 else None)
    with torch.cuda.device(dev):
        rc = lib.flash_prefill_bwd_latent_launch(
            int(dout.dtype == torch.bfloat16),
            q.data_ptr(), k.data_ptr(), dout.data_ptr(),
            None if split is None else split.data_ptr(), dq.data_ptr(),
            du.data_ptr(), stats.data_ptr(), part.data_ptr(), b, hq, n,
            slices, ctypes.c_float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("flash_prefill_bwd", rc)
    LAUNCHES["flash_prefill_bwd"] += 1
    return dq, du, None


def split_dout(x):
    """The latent route's split of an f32 dout alone, on the card: x f32
    (contiguous, 16-byte aligned, a multiple of 8 elements) → [2, *x.shape]
    bf16, hi = bf16(x) and lo = bf16(x - hi) (`ref.split_bf16_ref` is the
    plain version). Not counted: the route runs it inside its one launch."""
    build.check_tensors("flash_prefill_bwd", {
        "dout": (x, tuple(x.shape), torch.float32)}, x.device)
    build.check_copy_aligned("flash_prefill_bwd", dout=(x, 16))
    if x.numel() % 8:
        raise ValueError(f"flash_prefill_bwd: the split takes a multiple of "
                         f"8 elements, got {x.numel()}")
    lib = _bind(build.load("flash_prefill_bwd"))
    out = torch.empty((2, *x.shape), dtype=torch.bfloat16, device=x.device)
    with torch.cuda.device(x.device):
        rc = lib.flash_prefill_bwd_split_launch(
            x.data_ptr(), out.data_ptr(), x.numel(),
            torch.cuda.current_stream(x.device).cuda_stream)
    build.check_launch("flash_prefill_bwd", rc)
    return out


def flash_prefill_bwd(q, k, v, dout, scale: float = None):
    """Launch the dq kernel and the dk/dv kernel on the current stream →
    (dq, dk, dv); at (d, dv) = `LATENT` the latent route's kernels → (dq,
    du, None), du the latent's gradient through K and V. Raises on a
    tensor that is not contiguous and 16-byte aligned on the CUDA
    card (the latent route's v: that is not the view k[..., :dv]), on a
    shape or dtype the kernels do not take (dout f32 or bf16, bf16 only
    with bf16 q; the latent route bf16 q, k and v over one latent), and
    when a launch fails."""
    b, hq, n, d = q.shape
    hk = k.shape[1]
    dev = q.device
    if q.dtype not in KIND:
        raise TypeError(f"flash_prefill_bwd: dtype {q.dtype} not in "
                        f"{list(KIND)}")
    if dout.dtype not in KIND or (dout.dtype == torch.bfloat16
                                  and q.dtype != torch.bfloat16):
        raise TypeError(f"flash_prefill_bwd: dout is {dout.dtype}; it must "
                        "be f32, or bf16 with bf16 q, k and v")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if (d, v.shape[-1]) == LATENT:
        return _latent(q, k, v, dout, scale)
    if hk <= 0 or hq % hk or d % 16 or d > MAX_D or v.shape[-1] != d:
        raise ValueError(f"flash_prefill_bwd: Hq={hq} over Hk={hk}, head "
                         f"dims ({d}, {v.shape[-1]}): Hq must be a multiple "
                         f"of Hk, and d = dv a multiple of 16 up to {MAX_D}, "
                         f"or (d, dv) = {LATENT}")
    build.check_tensors("flash_prefill_bwd", {
        "q": (q, (b, hq, n, d), q.dtype),
        "k": (k, (b, hk, n, d), q.dtype), "v": (v, (b, hk, n, d), q.dtype),
        "dout": (dout, (b, hq, n, d), dout.dtype)}, dev)
    build.check_copy_aligned("flash_prefill_bwd", q=(q, 16), k=(k, 16),
                             v=(v, 16), dout=(dout, 16))
    lib = _bind(build.load("flash_prefill_bwd"))
    build.check_smem("flash_prefill_bwd",
                     lib.flash_prefill_bwd_smem_bytes(d), dev,
                     f"head dim {d}")
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    stats = torch.empty((3, b * hq, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        rc = lib.flash_prefill_bwd_launch(
            KIND[q.dtype], KIND[dout.dtype], q.data_ptr(), k.data_ptr(),
            v.data_ptr(), dout.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), stats.data_ptr(), b, hq, hk, n, d,
            ctypes.c_float(scale),
            torch.cuda.current_stream(dev).cuda_stream)
    build.check_launch("flash_prefill_bwd", rc)
    LAUNCHES["flash_prefill_bwd"] += 1
    return dq, dk, dv
