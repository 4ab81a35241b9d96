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

On a cache whose slots are split over ranks, `ShardStages` runs the long
route's kernels on this rank's block one stage a launch, and
`kernels/ops.sharded_decode` runs the collectives between them: the global
race (select_blocks 1) and the blocked race of one block a rank (the
one `kernels/fused_decode.py` runs whole), both on this source's
library.

`LAUNCHES["ragged_decode"]` counts the single-CTA route's launches,
`LAUNCHES["ragged_decode_long"]` the long route's and
`LAUNCHES["ragged_decode_shard"]` the sharded route's (one a call).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

LAUNCHES = {"ragged_decode": 0, "ragged_decode_long": 0,
            "ragged_decode_shard": 0}
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


# the race kernel's stages (csrc/decode_long.cuh, Scratch::mode)
RACE, CAND, ATTEND, PARTIAL, MZ = 1, 2, 4, 8, 16


def _bind_shard(lib):
    fn = lib.ragged_decode_shard_launch
    if fn.argtypes is None:
        fn.argtypes = ([_I] * 3 + [_P] * 15 + [_I] * 8
                       + [ctypes.c_float, _I, _P, _I, _I, _P])
        fn.restype = _I
        nb = lib.ragged_decode_shard_scratch_bytes
        nb.argtypes = [_I] * 4 + [_P]
        nb.restype = _Z
    return fn, lib.ragged_decode_shard_scratch_bytes


class ShardStages:
    """The sharded route's kernels on this rank's block of a cache whose
    slots are split over ranks (csrc/decode_long.cuh, `LaunchShard`), one
    stage a launch on the current stream, over one device scratch: `race`
    (score, then the race kernel: the global race's candidates, or the
    blocked race's final winners and their partials), `merge` (the ranks'
    gathered candidates raced again by `shard_merge_kernel`), `attend`
    (the partials over the winners the block holds), `probs` (with the
    row's merged (max, sum) that `set_mz` writes). The interface is
    `ref.ShardStagesRef`'s, which `ops.sharded_decode` drives; the
    collectives between the stages are its. Inputs as `ragged_decode`'s
    for the block (`fills`: the row's whole-cache fill, or None to score
    every slot, as the blocked race does), checked by `decode_spec`; both
    races launch this source's library, and `name` ("ragged_decode", or
    "fused_decode" for the blocked race) picks the count in `counter`
    that `race` adds to. Raises where a launch fails; nothing falls
    back."""

    def __init__(self, name, counter, fills, q, qq, qscale, mirror, mscale,
                 kscale, vscale, valid, prot, k, v, *, select_k: int,
                 offset: int):
        s = mirror.shape[1]
        q, ins, (bh, s, g, d, dv) = decode_spec(
            q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot, k,
            v, min(select_k, s), name)
        dev = q.device
        self.name, self.counter, self.dims = name, counter, (bh, s, g, d, dv)
        self.ins, self.offset, self.select_k = ins, offset, select_k
        self.slots = s
        self.kv = KV_KIND[k.dtype]
        self.fills = None
        if fills is not None:
            build.check_tensors(name, {"fills": (fills, (bh,), torch.int32)},
                                dev)
            self.fills = (fills - offset).clamp(0, s).to(torch.int32)
        self.fn, nbytes = _bind_shard(build.load("ragged_decode"))
        offs = (ctypes.c_size_t * 4)()
        self.scratch = torch.empty(nbytes(bh, s, g, select_k, offs),
                                   dtype=torch.uint8, device=dev)

        def view(at, dtype, shape):
            n = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
            return self.scratch[at:at + n].view(dtype).view(shape)
        self._cand = view(offs[0], torch.int32, (bh, select_k, 2))
        self._mz = view(offs[1], torch.float32, (bh, g, 2))
        self._opart = view(offs[2], torch.float32, (bh, g, 2))
        self._picks = view(offs[3], torch.int32, (bh, select_k))
        self.out = torch.empty((bh, g, dv), dtype=torch.float32, device=dev)
        self._probs = torch.empty((bh, s), dtype=torch.float32, device=dev)
        self.kc = min(select_k, s)

    def _launch(self, stage: int, mode: int, k: int, cand=None,
                n: int = 0) -> None:
        bh, s, g, d, dv = self.dims
        dev = self.out.device
        fills, block_s = ((None, s) if self.fills is None
                          else (self.fills.data_ptr(), BLOCK_S))
        with torch.cuda.device(dev):
            rc = self.fn(
                stage, mode, self.kv, fills,
                *(t.data_ptr() for t in self.ins), self.out.data_ptr(),
                self._probs.data_ptr(), self.scratch.data_ptr(), bh, s, g, d,
                dv, k, self.select_k, block_s,
                ctypes.c_float(1.0 / math.sqrt(d)), self.offset,
                None if cand is None else cand.data_ptr(), n, self.kc,
                torch.cuda.current_stream(dev).cuda_stream)
        build.check_launch(self.name, rc)

    def race(self, k: int, final: bool) -> None:
        self.counter[f"{self.name}_shard"] += 1
        if final:
            self._launch(0, RACE | ATTEND | PARTIAL | MZ, k)
        else:
            self.kc = min(k, self.dims[1])
            self._launch(0, RACE | CAND | MZ, self.kc)

    def candidates(self):
        return self._cand.view(-1)[:self.dims[0] * self.kc * 2].view(
            self.dims[0], self.kc, 2)

    def merge(self, gathered, k: int) -> None:
        n = gathered.shape[0]
        if 4 * n * self.kc > build.smem_limit(self.out.device) - 2048:
            raise ValueError(f"{self.name}: {n} x {self.kc} candidates "
                             "exceed the merge kernel's shared memory")
        self._gathered = gathered.contiguous()
        self._launch(1, 0, k, cand=self._gathered, n=n)

    def attend(self) -> None:
        self._launch(2, ATTEND | PARTIAL, self.select_k)

    def mz(self):
        return self._mz

    def set_mz(self, mz) -> None:
        self._mz.copy_(mz)

    def winners(self):
        """The global race's winners [BH, select_k], global slots (after
        `merge`)."""
        return self._picks.long() + self.offset

    def probs(self):
        self._launch(3, 0, self.select_k)
        return self._probs

    def partials(self):
        return self.out, self._opart[..., 0], self._opart[..., 1]
