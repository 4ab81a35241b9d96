"""Mixture-of-Experts layer: top-k routing and sort-based capacity
dispatch — the port of `repro/models/moe.py` (`init_moe`, `_expert_ffn`,
`apply_moe`; the expert-parallel `apply_moe_ep_shardmap` waits for the
multi-GPU slice).

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

