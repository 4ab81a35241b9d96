"""The fixed-slot KV cache with in-place overwrite — the port of
`repro/core/cache.py`.

The cache holds S = heavy_budget + reserve slots per kv-head; eviction never
compacts, it re-programs one row. The reference's `KVCache` NamedTuple
becomes a small dataclass with the same ten fields and the same
`[B, Hk, S, ·]` layout. Models stack it on a leading layer axis
(`[L, B, Hk, S, ·]`), and `layer(li)` returns views of one layer, so a
decode step writes its token straight into the stacked buffers with
`index_put_` (eager PyTorch updates in place; the reference's windowing and
scatter-ordering machinery has no counterpart here).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import PruneConfig
from repro_torch.core import quant
from repro_torch.core.topk import exact_topk

FIELDS = ("k", "v", "kq", "kscale", "vscale", "acc", "valid", "pos", "fill",
          "step")


@dataclass
class KVCache:
    k: torch.Tensor                  # [B, Hk, S, dh] compute dtype or int8
    v: Optional[torch.Tensor]        # [B, Hk, S, dv]
    kq: Optional[torch.Tensor]       # [B, Hk, S, dh] int8 mirror; None in
    #                                  int8 mode (k IS the mirror)
    kscale: Optional[torch.Tensor]   # [B, Hk, S] f32 (mirror or int8-K scale)
    vscale: Optional[torch.Tensor]   # [B, Hk, S] f32 (int8 mode only)
    acc: torch.Tensor                # [B, Hk, S] f32 accumulated scores
    valid: torch.Tensor              # [B, Hk, S] bool
    pos: torch.Tensor                # [B, Hk, S] int32 (absolute; -1 empty)
    fill: torch.Tensor               # [B] int32 slots filled
    step: torch.Tensor               # [B] int32 tokens seen (next abs pos)

    @property
    def slots(self) -> int:
        return self.k.shape[-2]

    @property
    def quantized_kv(self) -> bool:
        return self.k.dtype == torch.int8

    def k_values(self) -> torch.Tensor:
        """K rows in compute precision (dequantized in int8 mode)."""
        if self.quantized_kv:
            return quant.dequantize(self.k, self.kscale)
        return self.k

    def v_values(self) -> Optional[torch.Tensor]:
        if self.v is not None and self.quantized_kv:
            return quant.dequantize(self.v, self.vscale)
        return self.v

    def map(self, fn) -> "KVCache":
        """Apply `fn` to every present field."""
        return KVCache(*(None if getattr(self, f) is None
                         else fn(getattr(self, f)) for f in FIELDS))

    def layer(self, li: int) -> "KVCache":
        """Views of layer `li` of a layer-stacked cache: writes through them
        land in the stacked buffers."""
        return self.map(lambda a: a[li])

    def clone(self) -> "KVCache":
        return self.map(torch.clone)


def init_cache(batch: int, n_kv_heads: int, head_dim: int, slots: int,
               prune: PruneConfig, dtype=torch.bfloat16,
               v_dim: Optional[int] = None, device="cpu",
               layers: Optional[int] = None) -> KVCache:
    """Empty cache; `layers` adds a leading layer axis (stacked cache)."""
    if v_dim is None:
        v_dim = head_dim
    lead = () if layers is None else (layers,)
    shape = lead + (batch, n_kv_heads, slots, head_dim)
    int8_kv = prune.kv_dtype == "int8"
    if int8_kv:
        assert prune.policy == "unicaim", "int8 KV is a unicaim-mode knob"
        dtype = torch.int8
    # int8 K doubles as the CAM mirror → no separate copy
    needs_mirror = prune.policy == "unicaim" and not int8_kv
    needs_scale = needs_mirror or int8_kv
    row = shape[:-1]

    def zeros(shp, dt):
        return torch.zeros(shp, dtype=dt, device=device)

    return KVCache(
        k=zeros(shape, dtype),
        v=zeros(row + (v_dim,), dtype),
        kq=zeros(shape, torch.int8) if needs_mirror else None,
        kscale=zeros(row, torch.float32) if needs_scale else None,
        vscale=zeros(row, torch.float32) if int8_kv else None,
        acc=zeros(row, torch.float32),
        valid=zeros(row, torch.bool),
        pos=torch.full(row, -1, dtype=torch.int32, device=device),
        fill=zeros(lead + (batch,), torch.int32),
        step=zeros(lead + (batch,), torch.int32),
    )


# ---------------------------------------------------------------------------
# Per-lane surgery — continuous batching. `batch_axis=0` works on a
# single-layer cache, `batch_axis=1` on a layer-stacked one. All fields move
# together, the quantized mirrors and accumulated scores included.
# ---------------------------------------------------------------------------


def lane_slice(cache: KVCache, lane: int, batch_axis: int = 0) -> KVCache:
    """One lane as a batch-1 cache (a copy)."""
    return cache.map(lambda a: a.narrow(batch_axis, lane, 1).clone())


def lanes_insert(cache: KVCache, src, fresh: KVCache,
                 batch_axis: int = 0) -> KVCache:
    """In place: lane b takes `fresh` row `src[b]` where `src[b] >= 0` and
    keeps its contents at -1 (`src` is a host int array [B_live])."""
    lanes = [b for b, r in enumerate(src) if r >= 0]
    if not lanes:
        return cache
    dev = cache.k.device
    dst = torch.as_tensor(lanes, dtype=torch.long, device=dev)
    rows = torch.as_tensor([int(src[b]) for b in lanes], dtype=torch.long,
                           device=dev)
    for f in FIELDS:
        a, x = getattr(cache, f), getattr(fresh, f)
        if a is None:
            continue
        a.index_copy_(batch_axis, dst,
                      x.index_select(batch_axis, rows).to(a.dtype))
    return cache


def lane_reset(cache: KVCache, lane: int, batch_axis: int = 0) -> KVCache:
    """In place: empty one lane (as `init_cache` would make it)."""
    for f in FIELDS:
        a = getattr(cache, f)
        if a is not None:
            a.narrow(batch_axis, lane, 1).fill_(-1 if f == "pos" else 0)
    return cache


# ---------------------------------------------------------------------------
# Masks, slot choice and the token write.
# ---------------------------------------------------------------------------


def protected_mask(cache: KVCache, prune: PruneConfig) -> torch.Tensor:
    """[B, Hk, S] — slots that must never be evicted (sinks + recent)."""
    is_sink = (cache.pos >= 0) & (cache.pos < prune.sink_tokens)
    recent_floor = cache.step[:, None, None] - prune.recent_window
    is_recent = cache.pos >= recent_floor
    return cache.valid & (is_sink | is_recent)


def evictable_mask(cache: KVCache, prune: PruneConfig) -> torch.Tensor:
    return cache.valid & ~protected_mask(cache, prune)


def _choose_slot(cache: KVCache, prune: PruneConfig) -> torch.Tensor:
    """Per-(B, Hk) write slot: append while space, else policy eviction."""
    b, hk, s = cache.acc.shape
    append = cache.fill[:, None].long().expand(b, hk)
    if prune.policy == "streaming":
        # ring over the non-sink region (StreamingLLM)
        window = s - prune.sink_tokens
        ring = prune.sink_tokens + torch.remainder(
            cache.step[:, None].long() - prune.sink_tokens, window)
        return torch.where(cache.fill[:, None] < s, append, ring.expand(b, hk))
    # unicaim / h2o: argmin accumulated score among evictable slots; the
    # first index wins a tie (torch.argmin documents it, as lax does)
    score = torch.where(evictable_mask(cache, prune), cache.acc,
                        torch.full_like(cache.acc, float("inf")))
    evict = torch.argmin(score, dim=-1)                         # [B,Hk]
    full = cache.fill[:, None] >= s
    return torch.where(full, evict, append)


def _token_writes(cache: KVCache, k_new: torch.Tensor,
                  v_new: Optional[torch.Tensor], prune: PruneConfig,
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Slot choice + per-field row values for a one-token insert.
    Returns (slot [B, Hk] int64, {field: [B, Hk, ·] value at slot})."""
    b, hk, _ = cache.acc.shape
    slot = _choose_slot(cache, prune)
    vals: Dict[str, torch.Tensor] = {}
    if cache.quantized_kv:
        vals["k"], vals["kscale"] = quant.quantize(k_new, 8)
        if cache.v is not None:
            vals["v"], vals["vscale"] = quant.quantize(v_new, 8)
    else:
        vals["k"] = k_new.to(cache.k.dtype)
        if cache.v is not None:
            vals["v"] = v_new.to(cache.v.dtype)
        if cache.kq is not None:
            vals["kq"], vals["kscale"] = quant.quantize(k_new,
                                                        prune.score_bits)
    if prune.init_new_score == "mean":
        denom = torch.clamp(cache.valid.sum(dim=-1), min=1)
        vals["acc"] = (torch.where(cache.valid, cache.acc,
                                   torch.zeros_like(cache.acc)).sum(dim=-1)
                       / denom)
    else:
        vals["acc"] = torch.zeros((b, hk), dtype=torch.float32,
                                  device=cache.acc.device)
    vals["valid"] = torch.ones((b, hk), dtype=torch.bool,
                               device=cache.acc.device)
    vals["pos"] = cache.step[:, None].expand(b, hk).to(torch.int32)
    return slot, vals


def write_token(cache: KVCache, k_new: torch.Tensor,
                v_new: Optional[torch.Tensor], prune: PruneConfig,
                active: Optional[torch.Tensor] = None) -> KVCache:
    """Insert one token IN PLACE: static eviction + overwrite of one slot.

    k_new: [B, Hk, dh]; v_new: [B, Hk, dv]. `cache` may hold views into a
    layer-stacked cache (`KVCache.layer`); the writes land there.
    `active` ([B] bool, optional) freezes the other lanes: their slot keeps
    its old row and their fill/step stay, without a host sync."""
    b, hk, s = cache.acc.shape
    slot, vals = _token_writes(cache, k_new, v_new, prune)
    bi = torch.arange(b, device=slot.device)[:, None]
    hi = torch.arange(hk, device=slot.device)[None, :]
    for f, val in vals.items():
        dst = getattr(cache, f)
        if active is not None:
            old = dst[bi, hi, slot]
            m = active.reshape((b,) + (1,) * (val.dim() - 1))
            val = torch.where(m, val.to(dst.dtype), old)
        dst[bi, hi, slot] = val.to(dst.dtype)
    fill = torch.clamp(cache.fill + 1, max=s)
    step = cache.step + 1
    if active is not None:
        fill = torch.where(active, fill, cache.fill)
        step = torch.where(active, step, cache.step)
    cache.fill.copy_(fill)
    cache.step.copy_(step)
    return cache


# ---------------------------------------------------------------------------
# One-shot static pruning after prefill (§III-A.1).
# ---------------------------------------------------------------------------


def prefill_fill(cache: KVCache, k_full: torch.Tensor,
                 v_full: Optional[torch.Tensor], acc_scores: torch.Tensor,
                 prune: PruneConfig,
                 length: Optional[torch.Tensor] = None) -> KVCache:
    """Keep the `heavy_budget` heaviest prompt tokens per kv-head (sinks and
    recent tokens always kept), in position order in slots [0, keep).
    Returns a new cache of the same shape as `cache`.

    k_full: [B, Hk, N, dh]; acc_scores: [B, Hk, N]. `length` ([B] int32,
    optional) is the true prompt length of right-padded prompts: pads rank
    -inf, any pad that top-k still hands back (prompt shorter than the keep
    budget) is stored as an all-zero invalid slot, and pos/fill/step follow
    the real length."""
    b, hk, n, dh = k_full.shape
    dev = k_full.device
    s = cache.slots
    keep = min(prune.heavy_budget, n, s)
    bucketed = length is not None
    if length is None:
        length = torch.full((b,), n, dtype=torch.int32, device=dev)
    length = torch.clamp(length.to(torch.int32), max=n)

    pos_ids = torch.arange(n, device=dev)
    is_pad = pos_ids[None, :] >= length[:, None]                  # [B,N]
    inf = torch.tensor(float("inf"), device=dev)
    zero = torch.tensor(0.0, device=dev)
    if prune.policy in ("unicaim", "h2o"):
        sink = pos_ids[None, :] < prune.sink_tokens
        recent = pos_ids[None, :] >= (length[:, None] - prune.recent_window)
        bias = torch.where(sink, inf, zero) + torch.where(recent, inf, zero)
        ranked = acc_scores + bias[:, None, :]
    else:
        # dense/streaming keep the most recent tokens (+ sinks for streaming)
        ranked = (pos_ids.float()[None, None, :]
                  * torch.ones((b, hk, 1), device=dev))
        if prune.policy == "streaming":
            ranked = ranked + torch.where(pos_ids < prune.sink_tokens,
                                          inf, zero)[None, None, :]
    ranked = torch.where(is_pad[:, None, :], -inf, ranked)
    _, idx = exact_topk(ranked, keep)                             # [B,Hk,keep]
    idx, _ = torch.sort(idx, dim=-1)

    keep_n = torch.clamp(length, max=keep)                        # [B]
    slot_ok = (torch.arange(keep, device=dev)[None, None, :]
               < keep_n[:, None, None])

    def gather(x):  # [B,Hk,N,*] → [B,Hk,keep,*] (zeroed at inert slots)
        y = torch.gather(x, 2, idx[..., None].expand(-1, -1, -1, x.shape[-1]))
        return torch.where(slot_ok[..., None], y, torch.zeros_like(y)) \
            if bucketed else y

    def pad_slots(x, value=0):  # right-pad the slot axis (2) to S
        widths = [0, 0] * (x.dim() - 3) + [0, s - keep]
        return torch.nn.functional.pad(x, widths, value=value)

    out = dataclasses.replace(cache)
    if cache.quantized_kv:
        kc, ks = quant.quantize(gather(k_full), 8)
        out.k, out.kscale = pad_slots(kc), pad_slots(ks)
        if cache.v is not None:
            vc, vs = quant.quantize(gather(v_full), 8)
            out.v, out.vscale = pad_slots(vc), pad_slots(vs)
    else:
        k_sel = gather(k_full).to(cache.k.dtype)
        out.k = pad_slots(k_sel)
        if cache.v is not None:
            out.v = pad_slots(gather(v_full).to(cache.v.dtype))
        if cache.kq is not None:
            qn, sn = quant.quantize(k_sel, prune.score_bits)
            out.kq, out.kscale = pad_slots(qn), pad_slots(sn)

    acc_sel = torch.gather(acc_scores, 2, idx)
    valid_sel = slot_ok.expand(b, hk, keep)
    acc_sel = torch.where(valid_sel, acc_sel, torch.zeros_like(acc_sel))
    pos_sel = torch.where(valid_sel, idx, torch.full_like(idx, -1))
    out.acc = pad_slots(acc_sel.float())
    out.valid = pad_slots(valid_sel, value=False)
    out.pos = pad_slots(pos_sel.to(torch.int32), value=-1)
    out.fill = keep_n.to(torch.int32)
    out.step = length.to(torch.int32)
    return out
