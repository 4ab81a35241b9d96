"""UniCAIM attention — the port of `repro/core/attention.py`.

Decode step: the token write (static eviction), then CAM-mode scoring over
the quantized mirror → top-k selection → exact attention over the winners
→ charge-domain accumulation. The fused engine does the four stages in one
kernel (`kernels/ops.fused_decode`); the composed path is the oracle.

Prefill: causal attention that also returns the per-token accumulated
attention column sums (the `flash_prefill` kernel on the card), over the
whole prompt or one chunk of it, then the one-shot static pruning.

Slot-sharded decode: over a process mesh whose axes `_slot_axes` can
split the slots into the `select_blocks` blocks of the blocked race, each
rank holds only its shard of the cache (its batch rows on the batch axes,
its slot block on the slot axes; `shard_cache`, which records the block in
`cache.shard`), races its own k/nb winners, gathers and attends locally,
and combines by an all-reduce of the row max and one of the denominators
and partial outputs (`_blocked_attend_shardmap`). The layout is the
cache's own, not the active mesh's: a whole cache decodes unsharded under
any mesh. The other cross-slot choices of the step agree with the
unsharded step: the write slot (one all-gather of each rank's eviction
candidate) and the accumulated probabilities' softmax. As in the
reference, the fused kernels are not used under a mesh or on a shard, and
the local body is plain PyTorch.

The cache is updated IN PLACE: `decode_attention` takes a cache whose
tensors may be views into the layer-stacked buffers.
"""
from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import PruneConfig
from repro_torch.core import quant, scoring, topk
from repro_torch.core.cache import (KVCache, SlotShard, protected_mask,
                                    write_token)
from repro_torch.core.topk import NEG_INF
from repro_torch.device import kernel_capable
from repro_torch.kernels import ops
from repro_torch.runtime import sharding


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def _dense_attend(cache: KVCache, q: torch.Tensor, head_dim: int,
                  mask: Optional[torch.Tensor] = None):
    """Exact attention over all valid slots (and, given `mask` [B,Hq,S]
    bool, only those it keeps): q [B,Hq,d] → (out [B,Hq,dv], probs
    [B,Hq,S])."""
    s_exact = scoring.exact_scores(q, cache.k_values(), cache.valid)
    if mask is not None:
        s_exact = torch.where(mask, s_exact, torch.full_like(s_exact, NEG_INF))
    probs = scoring.score_probs(s_exact, head_dim)
    b, hq, s = probs.shape
    hk = cache.k.shape[1]
    out = torch.matmul(probs.reshape(b, hk, hq // hk, s),
                       cache.v_values().float())
    return out.reshape(b, hq, -1), probs


def _gathered_attend(cache: KVCache, q: torch.Tensor, idx: torch.Tensor,
                     head_dim: int) -> torch.Tensor:
    """Exact attention over the gathered top-k slots (current-domain CIM):
    q [B,Hq,d], idx [B,Hk,k] → out [B,Hq,dv] f32."""
    b, hq, d = q.shape
    _, hk, k = idx.shape
    g = hq // hk

    def rows(x):
        return torch.gather(x, 2, idx[..., None].expand(-1, -1, -1,
                                                        x.shape[-1]))

    k_sel, v_sel = rows(cache.k), rows(cache.v)
    valid_sel = torch.gather(cache.valid, 2, idx)                 # [B,Hk,k]
    if cache.quantized_kv:
        k_sel = k_sel.float() * torch.gather(cache.kscale, 2, idx)[..., None]
        v_sel = v_sel.float() * torch.gather(cache.vscale, 2, idx)[..., None]
    logits = torch.matmul(q.reshape(b, hk, g, d).float(),
                          k_sel.float().transpose(-1, -2))        # [B,Hk,g,k]
    logits = torch.where(valid_sel[:, :, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    probs = scoring.score_probs(logits.reshape(b, hq, k), head_dim)
    out = torch.matmul(probs.reshape(b, hk, g, k), v_sel.float())
    return out.reshape(b, hq, -1)


def _gathered_attend_blocked(cache: KVCache, q: torch.Tensor,
                             idx: torch.Tensor, head_dim: int) -> torch.Tensor:
    """Exact attention over block-local top-k slots (the per-array CAM
    race): q [B,Hq,d], idx [B,Hk,nb,k_loc] winners within each of the nb
    slot blocks → out [B,Hq,dv] f32, one softmax over all nb·k_loc
    winners."""
    b, hq, d = q.shape
    _, hk, nb, k_loc = idx.shape
    g = hq // hk
    s = cache.k.shape[2]

    def rows(x):                 # [B,Hk,S,·] → the winners [B,Hk,nb,kl,·]
        xb = x.reshape(b, hk, nb, s // nb, x.shape[-1])
        return torch.gather(xb, 3, idx[..., None].expand(
            -1, -1, -1, -1, x.shape[-1]))

    def per_slot(x):             # [B,Hk,S] → [B,Hk,nb,kl]
        return torch.gather(x.reshape(b, hk, nb, s // nb), 3, idx)

    k_sel, v_sel = rows(cache.k), rows(cache.v)
    valid_sel = per_slot(cache.valid)
    if cache.quantized_kv:
        k_sel = k_sel.float() * per_slot(cache.kscale)[..., None]
        v_sel = v_sel.float() * per_slot(cache.vscale)[..., None]
    logits = torch.einsum("bhgd,bhnkd->bhgnk", q.reshape(b, hk, g, d).float(),
                          k_sel.float()) / math.sqrt(head_dim)
    logits = torch.where(valid_sel[:, :, None], logits,
                         torch.full_like(logits, NEG_INF))
    m = logits.amax(dim=(-2, -1), keepdim=True)                 # cross-block
    e = torch.exp(logits - m) * (logits > NEG_INF / 2)
    z = e.sum(dim=(-2, -1), keepdim=True)
    p = e / torch.clamp(z, min=1e-30)
    out = torch.einsum("bhgnk,bhnkd->bhgd", p, v_sel.float())
    return out.reshape(b, hq, -1)


def _slot_axes(mesh, nb: int) -> Tuple[str, ...]:
    """Greedy prefix of (model, data, pod) whose sizes multiply to nb."""
    shape = sharding.mesh_shape(mesh)
    axes, prod = [], 1
    for a in ("model", "data", "pod"):
        if a in shape and prod < nb:
            axes.append(a)
            prod *= shape[a]
    return tuple(axes) if prod == nb else ()


def slot_layout(mesh, nb: int, batch: int
                ) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(batch axes, slot axes) of the slot-sharded decode over `mesh`: the
    slots split over `_slot_axes(mesh, nb)`, the batch rows over the other
    data axes that divide `batch` (the reference's shard_map specs)."""
    slot_axes = _slot_axes(mesh, nb)
    shape = sharding.mesh_shape(mesh)
    batch_axes = tuple(a for a in ("pod", "data")
                       if a in shape and a not in slot_axes
                       and batch % shape[a] == 0)
    return batch_axes, slot_axes


def _block(x: torch.Tensor, dim: int, i: int, n: int) -> torch.Tensor:
    step = x.shape[dim] // n
    return x.narrow(dim, i * step, step)


def shard_rows(x: torch.Tensor, mesh, nb: int, batch: int) -> torch.Tensor:
    """This rank's batch rows of a [batch, ...] tensor under
    `slot_layout` (a view)."""
    mesh = sharding.as_mesh(mesh)
    axes, _ = slot_layout(mesh, nb, batch)
    return _block(x, 0, mesh.coord(axes), mesh.size(axes)) if axes else x


def shard_cache(cache: KVCache, mesh, nb: int) -> KVCache:
    """This rank's shard of a whole [B, Hk, S, ·] cache under
    `slot_layout` over a process mesh: its batch rows and its slot block
    (a copy), with the block in `shard` when the slots split (a decode
    step on it then runs the slot-sharded race of `nb` blocks)."""
    mesh = sharding.as_mesh(mesh)
    b = cache.k.shape[0]
    batch_axes, slot_axes = slot_layout(mesh, nb, b)
    bi, bn = ((mesh.coord(batch_axes), mesh.size(batch_axes))
              if batch_axes else (0, 1))
    si, sn = mesh.coord(slot_axes), mesh.size(slot_axes)

    def cut(a):
        a = _block(a, 0, bi, bn)
        return _block(a, 2, si, sn) if a.dim() > 2 else a
    out = cache.map(lambda a: cut(a).clone())
    if slot_axes:
        s = out.slots
        out.shard = SlotShard(mesh.group(slot_axes), si * s, s * sn)
    return out


def check_slot_shard(cache: KVCache, prune: PruneConfig,
                     latent: bool = False) -> None:
    """Refuse a decode step on a slot-sharded cache unless `prune` runs the
    race the reference shards (unicaim, select_blocks > 1 — one block a
    rank —; for a GQA cache the top-k race too, while MLA's `latent` race
    ignores select_mode). Called before the step writes anything."""
    shard = cache.shard
    if shard is None:
        return
    blocks = shard.total // cache.slots
    if (prune.policy != "unicaim" or prune.select_blocks != blocks
            or (not latent and prune.select_mode != "topk")):
        raise ValueError(
            f"a cache slot-sharded over {blocks} ranks needs the unicaim "
            f"blocked race with select_blocks={blocks}"
            f"{'' if latent else ' and select_mode=topk'}; got "
            f"policy={prune.policy} select_blocks={prune.select_blocks} "
            f"select_mode={prune.select_mode}")


def _blocked_attend_shardmap(cache: KVCache, q: torch.Tensor,
                             biased: torch.Tensor, prune: PruneConfig,
                             group) -> torch.Tensor:
    """Shard-local top-k + gather + flash-decode combine: this rank races
    its own slot block (k/select_blocks winners), gathers and attends
    locally, and only the softmax statistics and the [B,Hq,dv] partial
    outputs cross `group`: one all-reduce of the row max, one of the
    denominators with the partial outputs. q [B,Hq,d] → out [B,Hq,dv]."""
    b, hq, d = q.shape
    hk = cache.k.shape[1]
    g = hq // hk
    k_loc = prune.select_k // prune.select_blocks
    _, idx = topk.exact_topk(biased, k_loc)                     # [B,Hk,kl]

    def rows(x):
        return torch.gather(x, 2, idx[..., None].expand(-1, -1, -1,
                                                        x.shape[-1]))

    k_sel, v_sel = rows(cache.k), rows(cache.v)
    valid_sel = torch.gather(cache.valid, 2, idx)
    if cache.quantized_kv:
        k_sel = k_sel.float() * torch.gather(cache.kscale, 2, idx)[..., None]
        v_sel = v_sel.float() * torch.gather(cache.vscale, 2, idx)[..., None]
    logits = torch.matmul(q.reshape(b, hk, g, d).float(),
                          k_sel.float().transpose(-1, -2)) / math.sqrt(d)
    logits = torch.where(valid_sel[:, :, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    m = sharding.all_reduce(logits.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(logits - m) * (logits > NEG_INF / 2)         # [B,Hk,g,kl]
    o = torch.matmul(e, v_sel.float())                         # [B,Hk,g,dv]
    oz = sharding.all_reduce(torch.cat([o, e.sum(dim=-1, keepdim=True)], -1),
                             "sum", group)
    out = oz[..., :-1] / torch.clamp(oz[..., -1:], min=1e-30)
    return out.reshape(b, hq, -1)


def fused_auto_decision(device) -> dict:
    """How `PruneConfig(fused="auto")` resolves for a cache on `device`:
    the fused engine (the hand-written `ragged_decode` / `fused_decode`
    kernels) on a CUDA card of compute capability >= 9.0, the composed
    path everywhere else. Keys as in the reference: engine, backend,
    reason."""
    dev = torch.device(device)
    return dict(_auto_decision(dev.type, dev.index))


@functools.lru_cache(maxsize=None)
def _auto_decision(dev_type: str, index: Optional[int]) -> dict:
    """`fused_auto_decision` for one device, made once: a decode step asks
    it on every layer."""
    dev = torch.device(dev_type, index)
    fused = kernel_capable(dev)
    backend = dev.type
    if dev.type == "cuda":
        backend += " sm_%d%d" % torch.cuda.get_device_capability(dev)
    return {
        "engine": "fused" if fused else "composed",
        "backend": backend,
        "reason": ("the fused decode kernels are built for sm_90a and run "
                   "on this card" if fused else
                   "no card of compute capability >= 9.0: the fused "
                   "kernels are built for sm_90a only, so the composed "
                   "path runs"),
    }


def _fused_enabled(prune: PruneConfig, device: torch.device) -> bool:
    if prune.fused == "auto":
        return _auto_decision(device.type, device.index)["engine"] == "fused"
    return bool(prune.fused)


def _fused_eligible(cache: KVCache, prune: PruneConfig) -> bool:
    """The fused engine covers the paper-default decode configuration; the
    threshold race, exact accumulation, MLA's latent cache (no V) and any
    active mesh stay on the composed path (under a mesh the composed path
    owns distribution, as in the reference)."""
    if not (_fused_enabled(prune, cache.k.device)
            and prune.policy == "unicaim"):
        return False
    if sharding.active_mesh() is not None or cache.shard is not None:
        return False
    if prune.select_mode != "topk" or prune.accumulate != "approx":
        return False
    if cache.v is None:                       # MLA latent cache
        return False
    return prune.select_k % max(1, prune.select_blocks) == 0


def _fused_decode_attend(cache: KVCache, q: torch.Tensor, prune: PruneConfig,
                         active: Optional[torch.Tensor]) -> torch.Tensor:
    """Single-pass fused engine: one kernel does CAM scoring, selection,
    the winner gather, exact attention AND emits the charge-domain
    probabilities. Updates `cache.acc` in place; returns out [B,Hq,dv]."""
    b, hq, d = q.shape
    hk = cache.k.shape[1]
    g = hq // hk
    s = cache.slots
    dv = cache.v.shape[-1]
    qq, qs = quant.quantize_query(q, prune.query_bits)
    mirror = cache.kq if cache.kq is not None else cache.k
    if cache.quantized_kv:
        kscale, vscale = cache.kscale, cache.vscale
    else:
        kscale = torch.ones((b, hk, s), dtype=torch.float32,
                            device=q.device)
        vscale = kscale
    prot = protected_mask(cache, prune)

    def bhf(x):                               # [B, Hk, ...] → [B·Hk, ...]
        return x.reshape((b * hk,) + tuple(x.shape[2:]))

    nb = max(1, prune.select_blocks)
    fills = torch.repeat_interleave(cache.fill, hk) if nb == 1 else None
    out, probs = ops.fused_decode(
        q.reshape(b * hk, g, d), qq.reshape(b * hk, g, d),
        qs.reshape(b * hk, g), bhf(mirror), bhf(cache.kscale), bhf(kscale),
        bhf(vscale), bhf(cache.valid.to(torch.int8)),
        bhf(prot.to(torch.int8)), bhf(cache.k), bhf(cache.v),
        select_k=prune.select_k, num_blocks=nb, fills=fills)
    _set_acc(cache, cache.acc * prune.acc_decay + probs.reshape(b, hk, s),
             active)
    return out.reshape(b, hq, dv)


def _set_acc(cache: KVCache, acc: torch.Tensor,
             active: Optional[torch.Tensor]) -> None:
    """Store the new accumulated scores in place, for active lanes only."""
    if active is not None:
        acc = torch.where(active[:, None, None], acc, cache.acc)
    cache.acc.copy_(acc)


def decode_attention(cache: KVCache, q: torch.Tensor, k_new: torch.Tensor,
                     v_new: torch.Tensor, prune: PruneConfig,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step, IN PLACE on `cache`.

    q: [B, Hq, d] current query (post-RoPE); k_new: [B, Hk, d], v_new:
    [B, Hk, dv] current token (post-RoPE). `active` ([B] bool, optional)
    freezes the other lanes' cache rows. Returns the attention output
    [B, Hq, dv] f32 (rows of inactive lanes are not meaningful).

    On a slot-sharded cache (`shard_cache`; module docstring), `cache` is
    this rank's shard and q, k_new and v_new are its batch rows
    (`shard_rows`)."""
    check_slot_shard(cache, prune)
    write_token(cache, k_new, v_new, prune, active)
    return _policy_attend(cache, q, prune, active)


def _policy_attend(cache: KVCache, q: torch.Tensor, prune: PruneConfig,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post-write half of a decode step: policy dispatch (dense / h2o /
    unicaim fused, or composed with the global top-k, the block-local race
    — slot-sharded on a sharded cache — or the threshold race) +
    charge-domain accumulation."""
    head_dim = q.shape[-1]
    hk = cache.k.shape[1]
    shard = cache.shard
    group = None if shard is None else shard.group

    if prune.policy in ("dense", "streaming"):
        out, _ = _dense_attend(cache, q, head_dim)
        return out

    if prune.policy == "h2o":
        out, probs = _dense_attend(cache, q, head_dim)
        _set_acc(cache, scoring.accumulate(cache.acc, probs, hk,
                                           prune.acc_decay), active)
        return out

    # ---- unicaim ----
    if _fused_eligible(cache, prune):
        return _fused_decode_attend(cache, q, prune, active)

    # CAM mode: approximate scores over the quantized mirror (in int8-KV
    # mode the stored K itself is the mirror)
    b, hq, _ = q.shape
    qq, qs = quant.quantize_query(q, prune.query_bits)
    mirror = cache.kq if cache.kq is not None else cache.k
    s_approx = scoring.approx_scores(qq, qs, mirror, cache.kscale,
                                     cache.valid)                # [B,Hq,S]
    grouped = topk.gqa_group_scores(s_approx, hk)                # [B,Hk,S]
    prot = protected_mask(cache, prune)

    if prune.select_mode == "threshold":
        # CAM race semantics: masked exact attention, no gather. The race
        # runs over the finite evictable scores only (the ±1e30 sentinels
        # would blow the binary search's resolution), the protected mask is
        # unioned back in, and the per-row target shrinks accordingly.
        evictable = cache.valid & ~prot
        k_dyn = torch.clamp(prune.select_k - prot.sum(dim=-1, keepdim=True),
                            min=1)
        mask = topk.threshold_race(grouped, k_dyn, prune.threshold_iters,
                                   eligible=evictable) | prot   # [B,Hk,S]
        mask_q = mask.repeat_interleave(hq // hk, dim=1)
        out, _ = _dense_attend(cache, q, head_dim, mask=mask_q)
    elif prune.select_blocks > 1:
        biased = topk.apply_selection_bias(grouped, prot, ~cache.valid)
        nb = prune.select_blocks
        s = biased.shape[-1] if shard is None else shard.total
        if s % nb or prune.select_k % nb:
            raise ValueError(f"blocked selection needs S={s} and select_k="
                             f"{prune.select_k} divisible by select_blocks="
                             f"{nb}")
        if shard is not None:
            out = _blocked_attend_shardmap(cache, q, biased, prune, group)
        else:
            _, idx = topk.exact_topk(biased.reshape(b, hk, nb, s // nb),
                                     prune.select_k // nb)  # [B,Hk,nb,kl]
            out = _gathered_attend_blocked(cache, q, idx, head_dim)
    else:
        biased = topk.apply_selection_bias(grouped, prot, ~cache.valid)
        _, idx = topk.exact_topk(biased, prune.select_k)         # [B,Hk,k]
        out = _gathered_attend(cache, q, idx, head_dim)

    # charge-domain mode: same-cycle accumulation of approximate probs
    if prune.accumulate == "approx":
        probs_acc = scoring.score_probs(s_approx, head_dim, group)
    else:  # 'exact' — full-precision probabilities (ablation)
        # the reference scores `cache.k` as stored: in int8 mode the codes,
        # without their scales (ROADMAP, quirks of the reference)
        probs_acc = scoring.score_probs(
            scoring.exact_scores(q, cache.k, cache.valid), head_dim, group)
    _set_acc(cache, scoring.accumulate(cache.acc, probs_acc, hk,
                                       prune.acc_decay), active)
    return out


# ---------------------------------------------------------------------------
# Prefill: chunked causal attention + accumulated column scores
# ---------------------------------------------------------------------------


def chunked_causal_attention(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, chunk: int = 512,
                             obs_window: int = 0,
                             scale: Optional[float] = None,
                             length: Optional[torch.Tensor] = None,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Causal attention over the prompt, with the column sums the static
    pruning ranks by.

    q: [B, Hq, N, d], k/v: [B, Hk, N, d] → (out [B, Hq, N, dv] f32,
    acc [B, Hk, N] f32 column sums of the attention probabilities).

    obs_window > 0 accumulates only the last `obs_window` query rows
    (SnapKV-style). `length` ([B] int32, optional) is the true length of
    right-padded prompts: rows at or past it add no column mass and the
    observation window anchors there; their outputs are not meaningful.

    On the card this is one launch of the `flash_prefill` kernel; on the
    CPU the plain version, one block of `chunk` query rows at a time
    (`kernels/ref.prefill_attention_ref`)."""
    return ops.prefill_attention(q, k, v, row0=0, length=length,
                                 obs_window=obs_window, chunk=chunk,
                                 scale=scale)


def prefill_chunk_attend(q_c: torch.Tensor, k_buf: torch.Tensor,
                         v_buf: torch.Tensor, row0: int,
                         length: torch.Tensor,
                         scale: Optional[float] = None,
                         obs_window: int = 0,
                         acc: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One prompt chunk attending into the streamed prefill K/V buffer.

    q_c: [B, Hq, C, d] queries of absolute rows [row0, row0+C); k_buf /
    v_buf: [B, Hk, N, ·] whose first row0+C rows are written (unwritten
    rows lie in every chunk row's causal future); length: [B] true prompt
    lengths. Returns (out [B, Hq, C, dv] f32, col_acc [B, Hk, N]: this
    chunk's column sums). Given `acc`, the column sums are added into it
    in place and it is returned as col_acc.

    On the card the kernel's column fold adds the q-blocks of the chunk in
    the order the whole-prompt call adds them, so a chunk size that is a
    multiple of its 64-row block accumulates bit-equal column sums."""
    return ops.prefill_attention(q_c, k_buf, v_buf, acc, row0=row0,
                                 length=length, obs_window=obs_window,
                                 chunk=q_c.shape[2], scale=scale)
