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
from repro_torch.kernels.flash_prefill import (
    LATENT, check_latent_v, flash_prefill as _flash_kernel)
from repro_torch.kernels.flash_prefill_bwd import (
    flash_prefill_bwd as _flash_bwd_kernel)
from repro_torch.kernels import fused_decode as fused_mod
from repro_torch.kernels import ragged_decode as ragged_mod
from repro_torch.kernels.fused_decode import fused_decode as _fused_kernel
from repro_torch.kernels.gather_attention import (
    gather_attention as _gather_kernel)
from repro_torch.kernels.ragged_decode import ragged_decode
from repro_torch.runtime import sharding


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


def sharded_decode(q, qq, qscale, mirror, mscale, kscale, vscale, valid,
                   prot, k, v, *, select_k: int, num_blocks: int, shard,
                   fills=None):
    """The fused decode on this rank's block of a cache whose slots are
    split over `shard.group` (a `core.cache.SlotShard`; the inputs are the
    block's, shapes as `fused_decode`'s over its S slots) → (out [BH,G,dv]
    f32: the whole row's attention, probs [BH,S] f32: the block's slots of
    the row's probabilities).

    `num_blocks` 1 is the global race: each rank's top select_k candidates
    (key, global slot), one all-gather, the same race over the gathered
    candidates (ties to the lower global slot), so the winner set is the
    unsharded race's; then the attention's partials over the winners the
    block holds. `num_blocks` equal to the slot ranks is the blocked race
    of one block a rank, final on its block. Then the rows' softmax
    statistics for probs and the attention's partials are merged over the
    ranks (`sharding.merge_shards`: two all-reduces and a few elementwise
    ops between the kernels, plain PyTorch on the card too: the
    flash-decode combine's epilogue). On the card the stages are the decode
    kernels' sharded route (`ragged_decode.ShardStages`, counted as
    `ragged_decode_shard` for the global race and `fused_decode_shard`
    for the blocked one), on the CPU their plain versions
    (`ref.ShardStagesRef`). `fills` ([BH] int32, the whole cache's) skips
    the block's dead slots on the global race."""
    s = mirror.shape[1]
    n = shard.total // s
    if num_blocks not in (1, n) or select_k % num_blocks:
        raise ValueError(f"sharded decode over {n} slot blocks: num_blocks "
                         f"{num_blocks} must be 1 or {n} and divide "
                         f"select_k={select_k}")
    ins = (q, qq, qscale, mirror, mscale, kscale, vscale, valid, prot, k, v)
    name = "ragged_decode" if num_blocks == 1 else "fused_decode"
    if _on_card(q, name):
        mod = ragged_mod if num_blocks == 1 else fused_mod
        st = ragged_mod.ShardStages(
            name, mod.LAUNCHES, fills if num_blocks == 1 else None, *ins,
            select_k=select_k, offset=shard.offset)
    else:
        st = ref.ShardStagesRef(*ins, offset=shard.offset)
    return shard_route(st, shard, select_k, num_blocks)


def shard_route(st, shard, select_k: int, num_blocks: int):
    """`sharded_decode`'s stages `st` (the kernels' `ragged_decode.
    ShardStages` or the plain `ref.ShardStagesRef`) with the collectives
    over `shard.group` between them → (out, probs)."""
    if num_blocks == 1:
        st.race(select_k, final=False)
        st.merge(sharding.gather_blocks(st.candidates(), shard), select_k)
        st.attend()
    else:
        st.race(select_k // (shard.total // st.slots), final=True)
    mz, out = sharding.merge_shards(st.mz(), *st.partials(), shard.group)
    st.set_mz(mz)
    return out, st.probs()


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
    they are not. MLA's latent shape (d, dv) = `LATENT` is the exception:
    its v is a view of k's first dv columns, and the kernel reads it where
    it lies (no copy of the latent); its plain version takes the latent
    route's f64 softmax denominators (`den_f64`)."""
    latent = (q.shape[-1], v.shape[-1]) == LATENT
    if not _on_card(q, "flash_prefill"):
        out, col = ref.prefill_attention_ref(
            q, k, v, row0=row0, length=length, obs_window=obs_window,
            chunk=chunk, scale=scale, den_f64=latent)
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
    dv = v.shape[-1]
    if not latent:
        v = v.contiguous()
    out = _flash_kernel(
        q.to(k.dtype).contiguous().reshape(b * hq, c, d),
        k.contiguous().reshape(b * hk, n, d),
        v.reshape(b * hk, n, dv), lengths,
        acc.view(b * hk, n), group=hq // hk, acc_group=hq // hk,
        row0=row0, obs_window=obs_window, model=True, scale=scale)
    return out.reshape(b, hq, c, -1), acc


def prefill_attention_bwd(q, k, v, dout, *, scale=None, chunk: int = 512):
    """The backward of `prefill_attention`'s out over a whole prompt (row0
    0, every row live): q [B,Hq,N,d], k [B,Hk,N,d], v [B,Hk,N,dv], dout
    [B,Hq,N,dv] → (dq, dk, dv) (`ref.flash_prefill_bwd_ref`). MLA's latent
    shape ((d, dv) = `LATENT`, Hk = 1), whose v must be the view of k's
    first dv columns, gives (dq, du, None) instead: du the latent's whole
    gradient, dk + [dv, 0] summed in f32 and rounded once
    (`ref.latent_du`), which is what autograd would add into it through
    the two views. On the card the `flash_prefill_bwd` kernel, with q cast
    to K's dtype, all made contiguous (copies where they are not) but the
    latent V, which its latent route reads where it lies; a bf16 dout goes
    to bf16 K/V's route as it is, any other is cast to f32 (which the bf16
    routes split into bf16 hi and lo halves). `chunk` only shapes the
    plain version's loop."""
    latent = (q.shape[-1], v.shape[-1]) == LATENT
    if latent:                          # du holds V's share: one tensor
        b, hk, n, d = k.shape
        if hk != 1:
            raise ValueError(f"prefill_attention_bwd: the latent shape "
                             f"{LATENT} takes one latent, got Hk = {hk}")
        check_latent_v(v.reshape(b, n, -1), k.reshape(b, n, d),
                       (b, n, v.shape[-1]), k.dtype, k.device,
                       "prefill_attention_bwd")
    if not _on_card(q, "flash_prefill_bwd"):
        dq, dk, dv = ref.flash_prefill_bwd_ref(q, k, v, dout, scale=scale,
                                               chunk=chunk)
        return (dq, ref.latent_du(dk, dv), None) if latent else (dq, dk, dv)
    keep = dout.dtype == torch.bfloat16 and k.dtype == torch.bfloat16
    dq, dk, dv = _flash_bwd_kernel(
        q.to(k.dtype).contiguous(), k.contiguous(),
        v if latent else v.contiguous(),
        (dout if keep else dout.to(torch.float32)).contiguous(),
        scale=scale)
    return dq.to(q.dtype), dk, dv


class _CausalAttention(torch.autograd.Function):
    """Differentiable causal prompt attention: `prefill_attention`'s out
    forward (its column sums dropped), cast to `out_dtype`, and
    `prefill_attention_bwd` backward, which so receives the cotangent in
    `out_dtype`. At MLA's latent shape k and v are views of one tensor
    (the latent and its first dv columns): the backward returns the
    latent's whole gradient as k's and None as v's, so autograd takes it
    through k's view alone."""

    @staticmethod
    def forward(ctx, q, k, v, scale, chunk, out_dtype):
        out, _ = prefill_attention(q, k, v, chunk=chunk, scale=scale)
        ctx.save_for_backward(q, k, v)
        ctx.scale, ctx.chunk = scale, chunk
        return out.to(out_dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = prefill_attention_bwd(q, k, v, dout, scale=ctx.scale,
                                           chunk=ctx.chunk)
        return dq, dk, dv, None, None, None


def causal_attention(q, k, v, scale=None, chunk: int = 512,
                     out_dtype=torch.float32):
    """Causal attention over a whole prompt with a gradient, the training
    forward's (the reference's `chunked_causal_attention` out under
    `jax.value_and_grad`): q [B,Hq,N,d], k/v [B,Hk,N,d] → out
    [B,Hq,N,dv] in `out_dtype` (f32 by default; the model passes its
    activations' dtype, the cast the reference makes right after
    `chunked_causal_attention`, so a bf16 model's backward takes a bf16
    cotangent, with the values the reference's cast gives). The forward is
    `prefill_attention` (the `flash_prefill` kernel on the card, its plain
    version on the CPU), the backward `prefill_attention_bwd` (the
    `flash_prefill_bwd` kernel, or `ref.flash_prefill_bwd_ref`)."""
    return _CausalAttention.apply(q, k, v, scale, chunk, out_dtype)
