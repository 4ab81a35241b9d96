"""UniCAIM attention — the port of `repro/core/attention.py`.

Decode step: the token write (static eviction), then CAM-mode scoring over
the quantized mirror → top-k selection → exact attention over the winners
→ charge-domain accumulation. The fused engine does the four stages in one
kernel (`kernels/ops.fused_decode`); the composed path is the oracle.

Prefill: causal attention that also returns the per-token accumulated
attention column sums (the `flash_prefill` kernel on the card), over the
whole prompt or one chunk of it, then the one-shot static pruning.

A cache laid out over a process mesh: `shard_decode_state` cuts a rank's
block of a layer-stacked state by the reference's `decode_state_pspecs`
(the batch rows over the data axes, the kv-heads over `model` where they
divide, the slots over what is left), and `shard_cache` one layer's by the
blocked race's axes (`slot_layout`). The layout is the cache's own
(`cache.rows`, `cache.heads`, `cache.shard`), not the active mesh's: a
whole cache decodes unsharded under any mesh. A rank's kv-heads or batch
rows decode as a whole cache of that size does, on the fused engine too.
Where the slots split (`cache.shard`), the step's cross-slot choices agree
with the unsharded step's: the write slot (one all-gather of each rank's
eviction candidate), the accumulated probabilities' softmax (its max and
denominator reduced over the slot ranks), and the race: the global race
(select_blocks 1) gathers each rank's top select_k candidates with their
global slots and races them again, so its winner set is the unsharded
one; the blocked race of one block a rank races locally. The attention
over the winners is then combined from the ranks' partials (row max,
denominator, unnormalised p·v). The fused engine runs the decode kernels'
sharded route there (`kernels/ops.sharded_decode`: the kernels on the
card, their plain stages on the CPU); the composed path does the same in
plain PyTorch (`_global_topk_shardmap`, `_owned_attend_shardmap`).

The cache is updated IN PLACE: `decode_attention` takes a cache whose
tensors may be views into the layer-stacked buffers.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.configs.base import PruneConfig
from repro_torch.core import quant, scoring, topk
from repro_torch.core.cache import (FIELDS, KVCache, SlotShard,
                                    protected_mask, write_token)
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
        out.shard = SlotShard(mesh.group(slot_axes), si * s, s * sn,
                              mesh.block_order(slot_axes))
    return out


class Layout(NamedTuple):
    """A rank's block of a [.., B, Hk, S, ·] cache over a process mesh: its
    batch rows, kv-heads and slots (a `SlotShard` each, None where the
    axis is whole)."""
    rows: Optional[SlotShard]
    heads: Optional[SlotShard]
    slots: Optional[SlotShard]


def _axis_block(mesh, entry, total: int) -> Optional[SlotShard]:
    """This rank's block of an axis of size `total` split over the mesh
    axes of one spec entry (its axes of size 1 dropped; None: whole)."""
    axes = () if entry is None else (
        (entry,) if isinstance(entry, str) else tuple(entry))
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    if not axes:
        return None
    n = mesh.size(axes)
    return SlotShard(mesh.group(axes), mesh.coord(axes) * (total // n),
                     total, mesh.block_order(axes))


def state_layout(mesh, shape) -> Optional[Layout]:
    """This rank's `Layout` of a layer-stacked [L, B, Hk, S, d] cache under
    the reference's `decode_state_pspecs` over a process mesh: the batch
    over the data axes that divide it, the kv-heads over `model` where Hk
    divides, the slots over `model` otherwise and over every idle axis
    that divides S (the batch-1 fold). None where nothing splits. Every
    rank calls it in the same order (a group of several axes is made
    collectively)."""
    mesh = sharding.as_mesh(mesh)
    spec = sharding.decode_state_pspecs(
        {"kv": {"k": torch.empty(tuple(shape), device="meta")}}, mesh)
    spec = tuple(spec["kv"]["k"]) + (None,) * 5
    out = Layout(*(_axis_block(mesh, spec[i], shape[i]) for i in (1, 2, 3)))
    return None if out == Layout(None, None, None) else out


def cut_cache(cache: KVCache, layout: Layout, batch_dim: int = 0,
              copy: bool = False) -> KVCache:
    """The block `layout` names of a whole cache (views, or copies with
    `copy`): the batch rows on `batch_dim` (1 for a layer-stacked cache),
    the kv-heads and slots on the two dims after it. `vscale` is cut with
    the slots, as every per-slot field is (the reference's rules leave it
    replicated; no number depends on it). The block carries the layout."""
    sizes = [None if blk is None else
             blk.total // sharding.group_size(blk.group) for blk in layout]

    def cut(a):
        for i, (blk, n) in enumerate(zip(layout, sizes)):
            if blk is not None and a.dim() > batch_dim + i:
                a = a.narrow(batch_dim + i, blk.offset, n)
        return a.clone() if copy else a
    out = KVCache(*(None if getattr(cache, f) is None else cut(getattr(
        cache, f)) for f in FIELDS))
    out.rows, out.heads, out.shard = layout
    return out


def check_layout_family(latent: bool, ssm: bool, cross: bool) -> None:
    """Refuse, before anything is cut or written, a decode state laid out
    over a process mesh whose family the layout does not take yet: MLA's
    `latent` cache, an `ssm` state (the SSM and hybrid families), an
    enc-dec model's `cross` K/V (ROADMAP, Queue C)."""
    what = [w for w, bad in (("MLA's latent cache", latent),
                             ("an SSM state", ssm),
                             ("an enc-dec model's cross K/V", cross)) if bad]
    if what:
        raise ValueError("a decode state laid out over a process mesh takes "
                         "the dense and MoE families' caches only; not "
                         + " or ".join(what))


def shard_decode_state(state, mesh):
    """This rank's block of a whole layer-stacked `DecodeState` over a
    process mesh, by the reference's `decode_state_pspecs` (`state_layout`):
    a copy of its batch rows, kv-heads and slots of every cache field,
    carrying the layout (`kv.rows`, `kv.heads`, `kv.shard`). A head-split
    block is a plain cache of Hk/n heads; a slot-split one decodes by the
    sharded race. The state itself where nothing splits. Refuses the
    families `check_layout_family` names."""
    kv = state.kv
    layout = None if kv is None else state_layout(mesh, kv.k.shape)
    if layout is None and state.ssm is None:
        return state
    check_layout_family(kv is not None and kv.v is None,
                        state.ssm is not None, state.cross is not None)
    return dataclasses.replace(state, kv=cut_cache(kv, layout, batch_dim=1,
                                                   copy=True))


def check_slot_shard(cache: KVCache, prune: PruneConfig,
                     latent: bool = False) -> None:
    """Refuse a decode step on a slot-sharded cache unless `prune` runs a
    race the slot ranks can share: the unicaim top-k race, global
    (select_blocks 1) or blocked with one block a rank; MLA's `latent`
    race (which ignores select_mode) only blocked. The threshold race, the
    dense, streaming and h2o policies and any other block count are
    refused. Called before the step writes anything."""
    shard = cache.shard
    if shard is None:
        return
    blocks = shard.total // cache.slots
    races = (blocks,) if latent else (1, blocks)
    if (prune.policy != "unicaim" or prune.select_blocks not in races
            or (not latent and prune.select_mode != "topk")):
        raise ValueError(
            f"a cache slot-sharded over {blocks} ranks needs the unicaim "
            f"race with select_blocks in {races}"
            f"{'' if latent else ' and select_mode=topk'}; got "
            f"policy={prune.policy} select_blocks={prune.select_blocks} "
            f"select_mode={prune.select_mode}")


def _owned_attend_shardmap(cache: KVCache, q: torch.Tensor,
                           idx: torch.Tensor, group) -> torch.Tensor:
    """Exact attention over winners split across the slot ranks, combined
    flash-decode style: idx [B,Hk,k] holds slots of this rank's block
    (those outside [0, S) are another rank's and count nothing here); this
    rank gathers and attends over its own valid winners, and only the
    softmax statistics and the [B,Hq,dv] partial outputs cross `group`:
    one all-reduce of the row max, one of the denominators with the
    partial outputs. q [B,Hq,d] → out [B,Hq,dv]."""
    b, hq, d = q.shape
    hk, s = cache.k.shape[1], cache.slots
    g = hq // hk
    mine = (idx >= 0) & (idx < s)
    idx = idx.clamp(0, s - 1)

    def rows(x):
        return torch.gather(x, 2, idx[..., None].expand(-1, -1, -1,
                                                        x.shape[-1]))

    k_sel, v_sel = rows(cache.k), rows(cache.v)
    valid_sel = torch.gather(cache.valid, 2, idx) & mine
    if cache.quantized_kv:
        k_sel = k_sel.float() * torch.gather(cache.kscale, 2, idx)[..., None]
        v_sel = v_sel.float() * torch.gather(cache.vscale, 2, idx)[..., None]
    logits = torch.matmul(q.reshape(b, hk, g, d).float(),
                          k_sel.float().transpose(-1, -2)) / math.sqrt(d)
    logits = torch.where(valid_sel[:, :, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    m = sharding.all_reduce(logits.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(logits - m) * (logits > NEG_INF / 2)         # [B,Hk,g,k]
    o = torch.matmul(e, v_sel.float())                         # [B,Hk,g,dv]
    oz = sharding.all_reduce(torch.cat([o, e.sum(dim=-1, keepdim=True)], -1),
                             "sum", group)
    out = oz[..., :-1] / torch.clamp(oz[..., -1:], min=1e-30)
    return out.reshape(b, hq, -1)


def _blocked_attend_shardmap(cache: KVCache, q: torch.Tensor,
                             biased: torch.Tensor, prune: PruneConfig,
                             group) -> torch.Tensor:
    """The blocked race of one block a rank: this rank races its own slot
    block (k/select_blocks winners), then `_owned_attend_shardmap`.
    q [B,Hq,d] → out [B,Hq,dv]."""
    _, idx = topk.exact_topk(biased, prune.select_k // prune.select_blocks)
    return _owned_attend_shardmap(cache, q, idx, group)


def _global_topk_shardmap(biased: torch.Tensor, k: int,
                          shard: SlotShard) -> torch.Tensor:
    """The global race over slots split across `shard.group`: each rank's
    top min(k, S) candidates with their global slots, all-gathered in
    block order and raced again (`topk.merge_candidates`) → idx [B,Hk,k]
    global slots, the set `exact_topk` gives over the whole cache, with its
    tie rule (the lower global slot)."""
    cands = topk.block_candidates(biased, k, shard.offset)
    return topk.merge_candidates(sharding.gather_blocks(cands, shard), k)


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
    threshold race, exact accumulation and MLA's latent cache (no V) stay
    on the composed path. A cache laid out over a process mesh takes it
    too, whatever mesh is active: a block of kv-heads or batch rows (or a
    whole cache) as an unsharded cache does, a slot-split block by the
    kernels' sharded route (the global race or one block a rank:
    `check_slot_shard` refused the rest)."""
    if not (_fused_enabled(prune, cache.k.device)
            and prune.policy == "unicaim"):
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
    probabilities. Updates `cache.acc` in place; returns out [B,Hq,dv].
    On a slot-split block, the kernels' sharded route (`ops.
    sharded_decode`) over this rank's slots."""
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
    args = (q.reshape(b * hk, g, d), qq.reshape(b * hk, g, d),
            qs.reshape(b * hk, g), bhf(mirror), bhf(cache.kscale),
            bhf(kscale), bhf(vscale), bhf(cache.valid.to(torch.int8)),
            bhf(prot.to(torch.int8)), bhf(cache.k), bhf(cache.v))
    if cache.shard is None:
        out, probs = ops.fused_decode(*args, select_k=prune.select_k,
                                      num_blocks=nb, fills=fills)
    else:
        out, probs = ops.sharded_decode(*args, select_k=prune.select_k,
                                        num_blocks=nb, shard=cache.shard,
                                        fills=fills)
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

    On a cache laid out over a process mesh (`shard_cache`,
    `shard_decode_state`; module docstring), `cache` is this rank's block
    and q, k_new and v_new are its batch rows and heads."""
    check_slot_shard(cache, prune)
    write_token(cache, k_new, v_new, prune, active)
    return _policy_attend(cache, q, prune, active)


def _policy_attend(cache: KVCache, q: torch.Tensor, prune: PruneConfig,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Post-write half of a decode step: policy dispatch (dense / h2o /
    unicaim fused, or composed with the global top-k, the block-local race
    or the threshold race; the global and blocked races over the slot
    ranks on a slot-sharded cache) + charge-domain accumulation."""
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
    elif shard is not None:
        biased = topk.apply_selection_bias(grouped, prot, ~cache.valid)
        idx = _global_topk_shardmap(biased, prune.select_k, shard)
        out = _owned_attend_shardmap(cache, q, idx - shard.offset, group)
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
