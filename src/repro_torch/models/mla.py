"""DeepSeek-V3 multi-head latent attention (MLA) with UniCAIM pruning in
latent space — the port of `repro/models/mla.py`.

The decode cache holds the compressed per-token latent u = [c_kv ⊕ k_rope]
(kv_lora + rope dims; one "kv head"). Scores use the absorbed query
q_abs = [W_ukᵀ q_nope ⊕ q_rope], so the CAM-mode pass and the exact pass
both run on the latent rows:

    q·k  ==  q_nope·(W_uk c) + q_rope·k_rope  ==  q_abs·u

Values are never made per token: attention contracts the probabilities
against the latents and up-projects once (ctx @ W_uv).

The prompt pass goes through `core.attention.chunked_causal_attention` at
the latent shape (d = kv_lora + rope, dv = kv_lora, all q-heads over one
latent), which on the card is the `flash_prefill` kernel's latent route.
Training (`mla_train`) runs the same attention through
`kernels/ops.causal_attention`, whose backward on the card is the latent
route of the `flash_prefill_bwd` kernel.
The decode step is plain PyTorch on every device, as the reference's is
plain XLA (no decode kernel takes a latent cache). It writes its token in
place through the layer's views of the stacked cache, with the semantics of
the reference's `mla_decode_stacked` (lanes outside `active` keep their
rows and `acc`); eager PyTorch needs neither its decode window nor its
`dep` pin.

Without a mesh the reference's `_latent_attend` takes the global top-k
whatever `select_blocks` and `select_mode` say, and accumulates the
approximate probabilities whatever `accumulate` says; the port follows
that code. On a latent cache slot-sharded into `select_blocks` blocks over
a process mesh (`core.attention.shard_cache`), each rank holds its shard
of the latent cache and races its own block (`_mla_blocked_shardmap`), as
the reference's shard_map does; the write slot and the accumulated softmax
span every rank's slots.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PruneConfig
from repro_torch.core import quant, scoring, topk
from repro_torch.core.attention import (_set_acc, check_slot_shard,
                                        chunked_causal_attention)
from repro_torch.core.cache import (KVCache, prefill_fill, protected_mask,
                                    write_token)
from repro_torch.core.topk import NEG_INF
from repro_torch.kernels import ops
from repro_torch.models.layers import dense_init, rope
from repro_torch.runtime import sharding


def init_mla(gen: torch.Generator, cfg: ModelConfig, dtype, device,
             lead=()):
    """wq_a, q_norm, wq_b, wkv_a, kv_norm, wkv_b and wo, stacked on `lead`
    (the norms at ones)."""
    m = cfg.mla
    h, d = cfg.n_heads, cfg.d_model
    lead = tuple(lead)

    def dense(d_in, d_out):
        return dense_init(gen, d_in, d_out, dtype, device, lead)

    def ones(width):
        return torch.ones(lead + (width,), dtype=dtype, device=device)

    return {
        "wq_a": dense(d, m.q_lora_rank),
        "q_norm": ones(m.q_lora_rank),
        "wq_b": dense(m.q_lora_rank, h * (m.qk_nope_dim + m.qk_rope_dim)),
        "wkv_a": dense(d, m.kv_lora_rank + m.qk_rope_dim),
        "kv_norm": ones(m.kv_lora_rank),
        "wkv_b": dense(m.kv_lora_rank, h * (m.qk_nope_dim + m.v_dim)),
        "wo": dense(h * m.v_dim, d),
    }


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6):
    """MLA's own RMS norm: f32 inside, back to x's dtype."""
    xf = x.float()
    y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _split_wkv_b(p, cfg: ModelConfig):
    """wkv_b → (W_uk [kv_lora, H, nope], W_uv [kv_lora, H, v])."""
    m = cfg.mla
    w = p["wkv_b"].reshape(m.kv_lora_rank, cfg.n_heads,
                           m.qk_nope_dim + m.v_dim)
    return w[..., :m.qk_nope_dim], w[..., m.qk_nope_dim:]


def _queries(p, x: torch.Tensor, cfg: ModelConfig, positions):
    """x [B,T,d] → q_nope [B,T,H,nope], q_rope [B,T,H,rope] (RoPE'd)."""
    m = cfg.mla
    b, t, _ = x.shape
    cq = _rms(x @ p["wq_a"], p["q_norm"])
    q = (cq @ p["wq_b"]).reshape(b, t, cfg.n_heads,
                                 m.qk_nope_dim + m.qk_rope_dim)
    q_nope, q_rope = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    return q_nope, rope(q_rope, positions, cfg.rope_theta)


def _latents(p, x: torch.Tensor, cfg: ModelConfig, positions):
    """x [B,T,d] → u [B,T,kv_lora+rope] (c_kv normed, k_rope RoPE'd on a
    single-head axis)."""
    m = cfg.mla
    kv = x @ p["wkv_a"]
    c_kv = _rms(kv[..., :m.kv_lora_rank], p["kv_norm"])
    k_rope = rope(kv[..., m.kv_lora_rank:][..., None, :], positions,
                  cfg.rope_theta)[..., 0, :]
    return torch.cat([c_kv, k_rope], dim=-1)


def _absorbed(q_nope, q_rope, w_uk) -> torch.Tensor:
    """[..., H, nope], [..., H, rope] → q_full [..., H, kv_lora + rope] f32:
    W_ukᵀ q_nope beside q_rope."""
    q_abs = torch.einsum("...hn,khn->...hk", q_nope.float(), w_uk.float())
    return torch.cat([q_abs, q_rope.float()], dim=-1)


def _scale_dim(cfg: ModelConfig) -> int:
    """The logits' scale is 1/sqrt(qk_nope + qk_rope), the per-head width
    the absorbed form stands for (not the latent's)."""
    return cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim


def _mla_attend(p, x: torch.Tensor, cfg: ModelConfig, positions, chunk: int,
                obs_window: int = 0, length: Optional[torch.Tensor] = None):
    """Absorbed-form chunked causal MLA → (out [B,T,d], u [B,T,latent],
    acc [B,1,T]). Scores and context both contract against the shared
    latent (Hk = 1; V is a view of its first kv_lora columns), then one
    up-projection per head."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _queries(p, x, cfg, positions)
    u = _latents(p, x, cfg, positions)
    w_uk, w_uv = _split_wkv_b(p, cfg)
    q_full = _absorbed(q_nope, q_rope, w_uk).transpose(1, 2)  # [B,H,T,lat]
    ctx, acc = chunked_causal_attention(
        q_full, u[:, None], u[:, None, :, :m.kv_lora_rank],
        chunk=min(chunk, t), obs_window=obs_window,
        scale=1.0 / math.sqrt(_scale_dim(cfg)), length=length)
    out = torch.einsum("bhtk,khv->bthv", ctx, w_uv.float())
    out = out.reshape(b, t, h * m.v_dim).to(x.dtype)
    return out @ p["wo"], u, acc


def mla_train(p, x: torch.Tensor, cfg: ModelConfig, positions,
              chunk: int = 0) -> torch.Tensor:
    """Causal MLA over whole sequences, with a gradient (the reference's
    `mla_train`): x [B,T,d] → [B,T,d]. The attention is
    `ops.causal_attention` over the latent, K = u and V the view of its
    first kv_lora columns, so autograd adds their gradients into u's as
    XLA's autodiff adds them in the reference; ctx stays f32 up to the
    W_uv product, as the reference's does, so the kernel's cotangent is
    f32."""
    m = cfg.mla
    b, t, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope = _queries(p, x, cfg, positions)
    u = _latents(p, x, cfg, positions)
    w_uk, w_uv = _split_wkv_b(p, cfg)
    q_full = _absorbed(q_nope, q_rope, w_uk).transpose(1, 2)  # [B,H,T,lat]
    ctx = ops.causal_attention(
        q_full, u[:, None], u[:, None, :, :m.kv_lora_rank],
        scale=1.0 / math.sqrt(_scale_dim(cfg)),
        chunk=min(chunk or cfg.attn_chunk, t), out_dtype=torch.float32)
    out = torch.einsum("bhtk,khv->bthv", ctx, w_uv.float())
    return out.reshape(b, t, h * m.v_dim).to(x.dtype) @ p["wo"]


def mla_prefill(p, x: torch.Tensor, cfg: ModelConfig, positions,
                prune: PruneConfig, cache: KVCache, chunk: int = 0,
                length: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, KVCache]:
    """Prompt pass with one-shot static pruning of the LATENT cache
    (`length`: true lengths of right-padded prompts) → (y [B,T,d], the
    filled cache)."""
    out, u, acc = _mla_attend(p, x, cfg, positions, chunk or cfg.attn_chunk,
                              obs_window=prune.prefill_obs_window,
                              length=length)
    return out, prefill_fill(cache, u[:, None], None, acc, prune,
                             length=length)


def mla_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
               prune: PruneConfig, active: Optional[torch.Tensor] = None
               ) -> torch.Tensor:
    """One decode step with UniCAIM selection in latent space, IN PLACE on
    `cache` (views of one layer of the stacked latent cache: Hk = 1, no V).
    x: [B,d] → y [B,d]. `active` ([B] bool, optional) freezes the other
    lanes' latent rows, fill, step and acc. On a slot-sharded latent cache
    (module docstring), `cache` is this rank's shard and x its batch
    rows."""
    m = cfg.mla
    b = x.shape[0]
    pos = cache.step[:, None].clone()                       # [B,1]
    q_nope, q_rope = _queries(p, x[:, None, :], cfg, pos)
    u_new = _latents(p, x[:, None, :], cfg, pos)[:, 0]      # [B,latent]
    check_slot_shard(cache, prune, latent=True)
    write_token(cache, u_new[:, None, :], None, prune, active)
    w_uk, w_uv = _split_wkv_b(p, cfg)
    q_full = _absorbed(q_nope[:, 0], q_rope[:, 0], w_uk)    # [B,H,latent]
    ctx = _latent_attend(cache, q_full, cfg, prune, active)
    out = torch.einsum("bhk,khv->bhv", ctx, w_uv.float())
    return out.reshape(b, cfg.n_heads * m.v_dim).to(x.dtype) @ p["wo"]


def _mla_blocked_shardmap(cache: KVCache, q_full: torch.Tensor,
                          biased: torch.Tensor, prune: PruneConfig,
                          kv_lora: int, scale_dim: int) -> torch.Tensor:
    """Shard-local latent selection for MLA decode (the distributed CAM
    race over the latent mirror): this rank's block of a slot-sharded
    latent cache ([B_loc, 1, S/nb, latent]) and of the biased scores races
    its own k/nb winners; the row max and the denominators with the
    partial contexts are all-reduced over the cache's slot group. q_full
    [B_loc, H, latent] → ctx [B_loc, H, kv_lora] f32."""
    group = cache.shard.group
    lat = cache.k.shape[-1]
    k_loc = prune.select_k // prune.select_blocks
    _, idx = topk.exact_topk(biased, k_loc)                  # [B,1,kl]
    u_sel = torch.gather(cache.k, 2, idx[..., None].expand(
        -1, -1, -1, lat))[:, 0]                              # [B,kl,lat]
    if cache.quantized_kv:
        u_sel = u_sel.float() * torch.gather(cache.kscale, 2,
                                             idx)[:, 0][..., None]
    valid_sel = torch.gather(cache.valid, 2, idx)[:, 0]      # [B,kl]
    logits = torch.einsum("bhl,bkl->bhk", q_full.float(),
                          u_sel.float()) / math.sqrt(scale_dim)
    logits = torch.where(valid_sel[:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    mx = sharding.all_reduce(logits.amax(dim=-1, keepdim=True), "max", group)
    e = torch.exp(logits - mx) * (logits > NEG_INF / 2)
    ctx = torch.einsum("bhk,bkl->bhl", e, u_sel[..., :kv_lora].float())
    cz = sharding.all_reduce(torch.cat([ctx, e.sum(dim=-1, keepdim=True)],
                                       -1), "sum", group)
    return cz[..., :-1] / torch.clamp(cz[..., -1:], min=1e-30)


def _latent_attend(cache: KVCache, q_full: torch.Tensor, cfg: ModelConfig,
                   prune: PruneConfig,
                   active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Policy attend over a latent cache that already holds the new token:
    q_full [B,H,latent] → ctx [B,H,kv_lora] f32; the charge-domain
    accumulator is updated in place (for `active` lanes).

    unicaim: CAM scores over the int8 mirror (in int8 mode the stored
    latent), the global top-k of the protected-biased scores, exact
    attention over the winners, and the approximate probabilities
    accumulated (the reference's code, whatever select_blocks, select_mode
    and accumulate say on a whole cache; on a slot-sharded cache, the
    shard-local race of `_mla_blocked_shardmap`). dense, h2o and
    streaming: exact attention over every valid slot (h2o accumulates its
    probabilities)."""
    m = cfg.mla
    scale_dim = _scale_dim(cfg)
    lat = cache.k.shape[-1]

    if prune.policy == "unicaim":
        qq, qs = quant.quantize_query(q_full, prune.query_bits)
        mirror = cache.kq if cache.kq is not None else cache.k
        s_apx = scoring.approx_scores(qq, qs, mirror, cache.kscale,
                                      cache.valid)             # [B,H,S]
        grouped = topk.gqa_group_scores(s_apx, 1)              # [B,1,S]
        biased = topk.apply_selection_bias(
            grouped, protected_mask(cache, prune), ~cache.valid)
        if cache.shard is not None:
            ctx = _mla_blocked_shardmap(cache, q_full, biased, prune,
                                        m.kv_lora_rank, scale_dim)
            _set_acc(cache, scoring.accumulate(
                cache.acc, scoring.score_probs(s_apx, scale_dim,
                                               cache.shard.group),
                1, prune.acc_decay), active)
            return ctx
        _, idx = topk.exact_topk(biased, prune.select_k)       # [B,1,k]
        u_sel = torch.gather(cache.k, 2, idx[..., None].expand(
            -1, -1, -1, lat))[:, 0]                            # [B,k,lat]
        if cache.quantized_kv:
            u_scale = torch.gather(cache.kscale, 2, idx)[:, 0]
            u_sel = u_sel.float() * u_scale[..., None]
        valid_sel = torch.gather(cache.valid, 2, idx)[:, 0]    # [B,k]
        logits = torch.einsum("bhk,bsk->bhs", q_full,
                              u_sel.float()) / math.sqrt(scale_dim)
        logits = torch.where(valid_sel[:, None, :], logits,
                             torch.full_like(logits, NEG_INF))
        pr = torch.softmax(logits, dim=-1)                     # [B,H,k]
        ctx = torch.einsum("bhs,bsk->bhk", pr,
                           u_sel[..., :m.kv_lora_rank].float())
        probs_acc = scoring.score_probs(s_apx, scale_dim)
        _set_acc(cache, scoring.accumulate(cache.acc, probs_acc, 1,
                                           prune.acc_decay), active)
        return ctx
    # dense / h2o / streaming over the latent cache
    u_all = cache.k_values()[:, 0].float()                     # [B,S,lat]
    logits = torch.einsum("bhk,bsk->bhs", q_full, u_all) / math.sqrt(
        scale_dim)
    logits = torch.where(cache.valid[:, 0][:, None, :], logits,
                         torch.full_like(logits, NEG_INF))
    pr = torch.softmax(logits, dim=-1)
    ctx = torch.einsum("bhs,bsk->bhk", pr, u_all[:, :, :m.kv_lora_rank])
    if prune.policy == "h2o":
        _set_acc(cache, scoring.accumulate(cache.acc, pr, 1,
                                           prune.acc_decay), active)
    return ctx
