"""Mixture-of-Experts layer: top-k routing and sort-based capacity
dispatch — the port of `repro/models/moe.py` (`init_moe`, `_expert_ffn`,
`apply_moe`, and the expert-parallel `apply_moe_ep_shardmap`, whose
all-to-alls run over a process mesh's `model` axis).

Tokens are ordered by destination expert (a stable sort), placed into an
[E, capacity, d] buffer whose overflow goes to one trash row (those
(token, choice) pairs are dropped), the expert FFNs run as batched products
over that buffer, and the outputs come back by the inverse permutation,
weighted by the renormalised gates in f32. The capacity is a function of
the token count of the whole call, so the rows of a batch compete for it:
pad tokens of a bucket and the other prompts of a group included, as in
the reference.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.core.topk import exact_topk
from repro_torch.models.layers import (activate, apply_mlp, dense_init,
                                       mlp_init)
from repro_torch.runtime import sharding

# While a caller holds a list here, every `apply_moe` call appends
# (its token count, the number of (token, choice) pairs the capacity
# dropped as a device tensor): no host sync. None: nothing is recorded.
DROPS: Optional[List[Tuple[int, torch.Tensor]]] = None


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             lead=()):
    """The router ([d, E], kept in f32 as the reference keeps it), the
    experts' wi/wo (and wg for SwiGLU) as [*lead, E, ·, ·], and the shared
    experts' MLPs as a list."""
    mo = cfg.moe
    d, ff, e = cfg.d_model, mo.d_ff_expert, mo.n_experts
    lead = tuple(lead)
    p = {"router": dense_init(gen, d, e, torch.float32, device, lead),
         "wi": dense_init(gen, d, ff, dtype, device, lead + (e,)),
         "wo": dense_init(gen, ff, d, dtype, device, lead + (e,))}
    if cfg.act == "swiglu":
        p["wg"] = dense_init(gen, d, ff, dtype, device, lead + (e,))
    if mo.n_shared > 0:
        p["shared"] = [mlp_init(gen, d, ff, cfg.act, dtype, device, lead)
                       for _ in range(mo.n_shared)]
    return p


def _expert_ffn(p, x: torch.Tensor, act: str) -> torch.Tensor:
    """x: [E, C, d] → [E, C, d], one batched product per weight."""
    gate = torch.bmm(x, p["wg"]) if act == "swiglu" else None
    return torch.bmm(activate(act, torch.bmm(x, p["wi"]), gate), p["wo"])


def capacity(n_tok: int, mo: MoEConfig) -> int:
    """Rows of each expert's buffer: ceil(n_tok · k · cf / E), at least 8,
    rounded up to a multiple of 8."""
    cap = max(-(-int(n_tok * mo.top_k * mo.capacity_factor)
                // mo.n_experts), 8)
    return -(-cap // 8) * 8


def route(p, xt: torch.Tensor, mo: MoEConfig):
    """xt: [T, d] → (router logits [T, E] f32, renormalised gates [T, k],
    experts [T, k]). Softmax gating, or sigmoid when the config has shared
    experts; among equal scores the lower expert wins, as in `lax.top_k`."""
    logits = xt.float() @ p["router"]
    scores = (torch.sigmoid(logits) if mo.n_shared
              else torch.softmax(logits, dim=-1))
    topv, topi = exact_topk(scores, mo.top_k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    return logits, topv, topi


def dispatch(topi: torch.Tensor, e: int, cap: int):
    """Sort-based dispatch of the [T, k] expert choices → (sort_idx, the
    buffer row of each sorted pair (e·cap, the trash row, where the
    expert's capacity is spent), counts per expert [E])."""
    flat_e = topi.reshape(-1)
    sorted_e, sort_idx = torch.sort(flat_e, stable=True)
    counts = torch.bincount(flat_e, minlength=e)
    offsets = torch.cumsum(counts, 0) - counts
    pos_in_e = torch.arange(flat_e.numel(), device=topi.device) - \
        offsets[sorted_e]
    dest_sorted = torch.where(pos_in_e < cap, sorted_e * cap + pos_in_e,
                              torch.full_like(pos_in_e, e * cap))
    return sort_idx, dest_sorted, counts


def dropped(topi: torch.Tensor, e: int, cap: int) -> torch.Tensor:
    """[T, k] bool: the (token, choice) pairs the capacity drops."""
    sort_idx, dest_sorted, _ = dispatch(topi, e, cap)
    out = torch.empty_like(dest_sorted, dtype=torch.bool)
    out[sort_idx] = dest_sorted == e * cap
    return out.reshape(topi.shape)


def _local_experts(w: torch.Tensor, e: int, e_loc: int, me: int
                   ) -> torch.Tensor:
    """This rank's experts of an expert weight: a DTensor laid out by the
    rules is redistributed to experts on `model` and whole elsewhere (as
    the reference's shard_map in_specs) and its local shard taken; else
    the rank's slice of the whole [E, ·, ·] tensor, or the tensor itself
    when it holds E / ep experts already."""
    if hasattr(w, "to_local"):
        from torch.distributed.tensor import Replicate, Shard
        mesh = w.device_mesh
        w = w.redistribute(mesh, [
            Shard(0) if name == "model" else Replicate()
            for name in mesh.mesh_dim_names]).to_local()
    if w.shape[0] == e and e_loc != e:
        w = w[me * e_loc:(me + 1) * e_loc]
    return w


def apply_moe_ep_shardmap(p, x: torch.Tensor, cfg: ModelConfig, mesh
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over a process mesh's `model` axis: the
    reference's two-stage all-to-all dispatch.

    `x` [b, t, d] is this rank's rows: the batch split over the mesh's
    data axes ("pod" and "data", those it has) and replicated over
    `model`. The rank routes its own tokens, packs one send queue of
    `cap` rows a destination shard (experts [j·E/ep, (j+1)·E/ep) live on
    model rank j), and one all-to-all moves the payloads and one their
    expert ids. The received rows are dispatched again by a local stable
    sort into E/ep buffers of `cap2` rows (the trash row takes overflow),
    the rank's experts run as batched products, a second all-to-all
    returns each row to its source, and the gate-weighted outputs are
    summed per token in f32. The aux loss is averaged over the data
    axes. The expert weights may be
    whole, the rank's slice, or DTensors sharded on experts. Requires
    n_experts divisible by the model axis. Returns (y [b, t, d], aux)."""
    mesh = sharding.as_mesh(mesh)
    mo = cfg.moe
    b, t, d = x.shape
    e, k = mo.n_experts, mo.top_k
    ep = mesh.shape["model"]
    e_loc = e // ep
    group, me = mesh.group("model"), mesh.coord("model")
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)
    n_loc = b * t
    # per-(src shard → dst shard) capacity, a multiple of 8
    cap = max(-(-int(n_loc * k * mo.capacity_factor) // ep), 8)
    cap = -(-cap // 8) * 8
    dev = x.device

    xt = x.reshape(n_loc, d)
    logits, topv, topi = route(p, xt, mo)
    flat_e = topi.reshape(-1)                                 # [n_loc·k]
    dest_shard = flat_e // e_loc
    sorted_dst, sort_idx = torch.sort(dest_shard, stable=True)
    counts = torch.bincount(dest_shard, minlength=ep)
    offs = torch.cumsum(counts, 0) - counts
    pos_in = torch.arange(n_loc * k, device=dev) - offs[sorted_dst]
    keep = pos_in < cap
    send_slot = torch.where(keep, sorted_dst * cap + pos_in,
                            torch.full_like(pos_in, ep * cap))
    tok_of = sort_idx // k
    send = torch.zeros((ep * cap + 8, d), dtype=x.dtype, device=dev)
    send[send_slot] = xt[tok_of]
    send_eid = torch.full((ep * cap + 8,), -1, dtype=torch.long, device=dev)
    send_eid[send_slot] = flat_e[sort_idx]
    rx = sharding.all_to_all(send[:ep * cap], group)          # [ep·cap, d]
    re_id = sharding.all_to_all(send_eid[:ep * cap], group)
    # the second-stage LOCAL sort dispatch: each local expert computes only
    # its own rows
    r_tot = ep * cap
    le = torch.where(re_id >= 0, re_id % e_loc,
                     torch.full_like(re_id, e_loc))           # e_loc: trash
    s_le, s_idx = torch.sort(le, stable=True)
    cnts = torch.bincount(le, minlength=e_loc + 1)
    offs2 = torch.cumsum(cnts, 0) - cnts
    cap2 = -(-int(r_tot // max(e_loc, 1) * 1.25) // 8) * 8
    pos2 = torch.arange(r_tot, device=dev) - offs2[s_le]
    ok2 = (pos2 < cap2) & (s_le < e_loc)
    dest2 = torch.where(ok2, s_le * cap2 + pos2,
                        torch.full_like(pos2, e_loc * cap2))
    buf = torch.zeros((e_loc * cap2 + 1, d), dtype=rx.dtype, device=dev)
    buf[dest2] = rx[s_idx]
    local = {name: _local_experts(p[name], e, e_loc, me)
             for name in ("wi", "wg", "wo") if name in p}
    ex_out = _expert_ffn(local, buf[:-1].reshape(e_loc, cap2, d), cfg.act)
    out_buf = torch.cat([ex_out.reshape(e_loc * cap2, d),
                         ex_out.new_zeros((1, d))])
    inv2 = torch.empty_like(dest2)
    inv2[s_idx] = dest2
    # the payloads back to their source shards
    back = sharding.all_to_all(out_buf[inv2], group)          # [ep·cap, d]
    back = torch.cat([back, back.new_zeros((8, d))])
    gate = (topv.reshape(-1)[sort_idx] * keep)[:, None]
    y = torch.zeros((n_loc, d), dtype=torch.float32, device=dev)
    y.index_add_(0, tok_of, back[send_slot].float() * gate)

    probs = torch.softmax(logits, dim=-1)
    f_e = torch.bincount(flat_e, minlength=e).float() / (n_loc * k)
    aux = e * torch.sum(f_e * probs.mean(dim=0)) * mo.aux_loss_weight
    if batch_axes:
        aux = sharding.all_reduce(aux, "sum", mesh.group(batch_axes)) \
            / mesh.size(batch_axes)
    y = y.reshape(b, t, d).to(x.dtype)
    for sp in p.get("shared", ()):
        y = y + apply_mlp(sp, x, cfg.act)
    return y, aux


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: [B, T, d] → (y [B, T, d], the Switch load-balancing aux loss, a
    scalar f32 tensor)."""
    mo = cfg.moe
    b, t, d = x.shape
    n_tok = b * t
    e, k = mo.n_experts, mo.top_k
    cap = capacity(n_tok, mo)
    xt = x.reshape(n_tok, d)
    logits, topv, topi = route(p, xt, mo)
    sort_idx, dest_sorted, counts = dispatch(topi, e, cap)
    if DROPS is not None:
        DROPS.append((n_tok, (dest_sorted == e * cap).sum()))

    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[dest_sorted] = xt[sort_idx // k]
    ex_out = _expert_ffn(p, buf[:-1].reshape(e, cap, d), cfg.act)
    out_buf = torch.cat([ex_out.reshape(e * cap, d),
                         ex_out.new_zeros((1, d))])
    # the inverse permutation: each (token, choice) pair's output row
    dest = torch.empty_like(dest_sorted)
    dest[sort_idx] = dest_sorted
    y = (out_buf[dest].reshape(n_tok, k, d).float()
         * topv[..., None]).sum(dim=1).to(x.dtype)

    probs = torch.softmax(logits, dim=-1)
    frac_tokens = counts.float() / (n_tok * k)
    aux = e * torch.sum(frac_tokens * probs.mean(dim=0)) * mo.aux_loss_weight

    for sp in p.get("shared", ()):
        y = y + apply_mlp(sp, x, cfg.act).reshape(n_tok, d)
    return y.reshape(b, t, d), aux

