"""Dispatch to the Hopper kernels — the port of `repro/kernels/ops.py`.

A CUDA tensor on a card of compute capability >= 9.0 goes to the kernel, a
CPU tensor to the kernel's plain PyTorch version in `kernels/ref.py`, and
anything else raises. There is no fallback: a build or launch failure on
the card raises. The reference's TPU tiling and backend arguments
(`block_s`, `block_q`, `block_k`, `backend`) have no counterpart here.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.device import kernel_capable
from repro_torch.kernels import ref
from repro_torch.kernels.approx_score import approx_score as _approx_kernel
from repro_torch.kernels.flash_prefill import flash_prefill as _flash_kernel
from repro_torch.kernels.fused_decode import fused_decode as _fused_kernel
from repro_torch.kernels.gather_attention import (
    gather_attention as _gather_kernel)
from repro_torch.kernels.ragged_decode import ragged_decode


def _on_card(x: torch.Tensor, kernel: str) -> bool:
    """False for a CPU tensor (the plain version); True on an sm_90 card;
    raises on any other device."""
    if x.device.type == "cpu":
        return False
    if not kernel_capable(x.device):
        raise RuntimeError(f"no {kernel} kernel for {x.device}: the port's "
                           "kernels need compute capability >= 9.0")
    return True


def _pad_slots(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Right-pad axis 1 (the slot axis) with `pad` zeros."""
    widths = [0, 0] * (x.dim() - 2) + [0, pad]
    return F.pad(x, widths)


def approx_score(qq, qscale, kq, kscale, valid):
    """CAM-mode scoring → [BH, G, S] f32. Shapes as in
    `kernels/approx_score.py`."""
    valid = valid.to(torch.int8)
    if not _on_card(qq, "approx_score"):
        return ref.approx_score_ref(qq, qscale, kq, kscale, valid)
    return _approx_kernel(qq, qscale.float(), kq, kscale.float(), valid)


def gather_attention(q, k, v, valid):
    """Current-domain exact attention over gathered slots → [BH, G, dv]
    f32. Held to the reference's oracle, including a row with no valid slot
    (the mean of its K value rows); the reference's op pads K to its TPU
    block and so averages over the padding there."""
    valid = valid.to(torch.int8)
    if not _on_card(q, "gather_attention"):
        return ref.gather_attention_ref(q, k, v, valid)
    return _gather_kernel(q, k, v, valid)


def fused_decode(q, qq, qscale, mirror, mscale, kscale, vscale, valid,
                 prot, k, v, select_k: int, num_blocks: int = 1, fills=None):
    """Fused single-pass pruned decode (score → select → gather → attend)
    → (out [BH, G, dv] f32, probs [BH, S] f32).

    With global selection (`num_blocks == 1`) and per-row live counts
    `fills` ([BH] int32) a card runs the ragged kernel, which skips the
    dead slot blocks of each row. Otherwise it runs the fused kernel, whose
    `num_blocks` selection blocks race for select_k / num_blocks winners
    each. A ragged tail (S % num_blocks) is padded with invalid slots, which
    never win, and probs are cut back to S."""
    if fills is not None and num_blocks == 1 and _on_card(q, "ragged_decode"):
        return ragged_decode(fills, q, qq, qscale, mirror, mscale, kscale,
                             vscale, valid, prot, k, v, select_k=select_k)
    s = mirror.shape[1]
    pad = (-s) % num_blocks
    if pad:
        mirror, mscale, kscale, vscale, valid, prot, k, v = (
            _pad_slots(x, pad) for x in (mirror, mscale, kscale, vscale,
                                         valid, prot, k, v))
    if _on_card(q, "fused_decode"):
        out, probs = _fused_kernel(q, qq, qscale, mirror, mscale, kscale,
                                   vscale, valid, prot, k, v,
                                   select_k=select_k, num_blocks=num_blocks)
    else:
        out, probs = ref.fused_decode_ref(q, qq, qscale, mirror, mscale,
                                          kscale, vscale, valid, prot, k, v,
                                          select_k=select_k,
                                          num_blocks=num_blocks)
    return out, probs[:, :s]


def flash_prefill(q, k, v, group: int = 1, lengths=None):
    """Causal attention with per-q-head column sums, the TPU contract:
    q [BH,N,d], k/v [BH/group,N,d] (q's dtype) → (out [BH,N,d] in q's
    dtype, acc [BH,N] f32). `lengths` ([BH] int32, optional): rows at or
    past them add no column mass. N need not divide any block."""
    if not _on_card(q, "flash_prefill"):
        return ref.flash_prefill_ref(q, k, v, group, lengths=lengths)
    bh, n, _ = q.shape
    if lengths is None:
        lengths = torch.full((bh,), n, dtype=torch.int32, device=q.device)
    acc = torch.zeros((bh, n), dtype=torch.float32, device=q.device)
    out = _flash_kernel(q.contiguous(), k.contiguous(), v.contiguous(),
                        lengths.to(torch.int32).contiguous(), acc,
                        group=group, acc_group=1, model=False)
    return out, acc


def prefill_attention(q, k, v, acc=None, *, row0: int = 0, length=None,
                      obs_window: int = 0, chunk: int = 512, scale=None):
    """Causal prompt attention with kv-head column sums, the model's
    contract (`ref.prefill_attention_ref`): q [B,Hq,C,d] for absolute rows
    [row0, row0+C) of the K/V buffers k/v [B,Hk,N,d] → (out [B,Hq,C,dv]
    f32, acc [B,Hk,N] f32). Given `acc`, the column sums are added into it
    IN PLACE and it is returned; otherwise a fresh one is. `chunk` only
    shapes the plain version's loop over query rows.

    On the card q is cast to K's dtype, and q, k and v are made contiguous
    (the model's q is a transposed view of its projection): a copy where
    they are not."""
    if not _on_card(q, "flash_prefill"):
        out, col = ref.prefill_attention_ref(
            q, k, v, row0=row0, length=length, obs_window=obs_window,
            chunk=chunk, scale=scale)
        if acc is None:
            return out, col
        acc += col
        return out, acc
    b, hq, c, d = q.shape
    hk, n = k.shape[1], k.shape[2]
    if acc is None:
        acc = torch.zeros((b, hk, n), dtype=torch.float32, device=q.device)
    if length is None:
        length = torch.full((b,), n, dtype=torch.int32, device=q.device)
    lengths = torch.repeat_interleave(
        torch.clamp(length.to(torch.int32), max=n), hq)
    out = _flash_kernel(
        q.to(k.dtype).contiguous().reshape(b * hq, c, d),
        k.contiguous().reshape(b * hk, n, d),
        v.contiguous().reshape(b * hk, n, v.shape[-1]), lengths,
        acc.view(b * hk, n), group=hq // hk, acc_group=hq // hk,
        row0=row0, obs_window=obs_window, model=True, scale=scale)
    return out.reshape(b, hq, c, -1), acc
