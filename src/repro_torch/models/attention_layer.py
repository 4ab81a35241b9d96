"""GQA attention block wired to the UniCAIM cache — the port of
`repro/models/attention_layer.py` (prefill, chunked prefill and
decode)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PruneConfig
from repro_torch.core.attention import decode_attention, prefill_chunk_attend
from repro_torch.core.cache import KVCache
from repro_torch.core.pruning import prefill_and_prune
from repro_torch.models.layers import rope


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions):
    """x: [B,T,d] → q [B,Hq,T,dh], k/v [B,Hk,T,dh] (RoPE applied)."""
    b, t, _ = x.shape
    q = (x @ p["wq"]).reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attention_prefill(p, x: torch.Tensor, cfg: ModelConfig, positions,
                      prune: PruneConfig, cache: KVCache, chunk: int = 0,
                      length: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, KVCache]:
    """Prompt pass: causal attention + one-shot static pruning. `length`
    ([B] int32, optional) marks the true lengths of right-padded prompts.
    Returns (y [B,T,d], the filled cache)."""
    b, t, _ = x.shape
    chunk = chunk or cfg.attn_chunk
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache, out = prefill_and_prune(cache, q, k, v, prune,
                                   chunk=min(chunk, t), length=length)
    out = out.transpose(1, 2).reshape(b, t, cfg.q_dim).to(x.dtype)
    return out @ p["wo"], cache


def attention_prefill_chunk(p, x: torch.Tensor, cfg: ModelConfig, positions,
                            prune: PruneConfig, k_buf: torch.Tensor,
                            v_buf: torch.Tensor, acc: torch.Tensor, row0: int,
                            length: torch.Tensor):
    """One chunk of a time-sliced (chunked) prefill.

    x: [B,C,d] hidden for absolute rows [row0, row0+C); k_buf/v_buf:
    [B,Hk,N,dh] streamed prompt K/V (rows < row0 already written); acc:
    [B,Hk,N] running column sums. Projects the chunk, writes its K/V into
    the buffers at row0 and adds its column sums into acc, all IN PLACE,
    and attends causally over the buffer. Returns (y [B,C,d], k_buf,
    v_buf, acc)."""
    b, c, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    k_buf[:, :, row0:row0 + c] = k.to(k_buf.dtype)
    v_buf[:, :, row0:row0 + c] = v.to(v_buf.dtype)
    out, acc = prefill_chunk_attend(q, k_buf, v_buf, row0, length,
                                    obs_window=prune.prefill_obs_window,
                                    acc=acc)
    out = out.transpose(1, 2).reshape(b, c, cfg.q_dim).to(x.dtype)
    return out @ p["wo"], k_buf, v_buf, acc


def decode_qkv(p, x: torch.Tensor, cfg: ModelConfig, cache: KVCache):
    """Decode projections: x [B,d] → q [B,Hq,dh], k/v [B,Hk,dh], rotated
    at each lane's position `cache.step`."""
    b, _ = x.shape
    q = (x @ p["wq"]).reshape(b, cfg.n_heads, cfg.head_dim)
    k = (x @ p["wk"]).reshape(b, cfg.n_kv_heads, cfg.head_dim)
    v = (x @ p["wv"]).reshape(b, cfg.n_kv_heads, cfg.head_dim)
    if cfg.pos == "rope":
        pos = cache.step[:, None]                           # [B,1]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def attention_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                     prune: PruneConfig,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step, writing `cache` (views of one layer of the stacked
    cache) in place. x: [B,d] → y [B,d]."""
    q, k, v = decode_qkv(p, x, cfg, cache)
    out = decode_attention(cache, q, k, v, prune, active)
    return out.reshape(x.shape[0], cfg.q_dim).to(x.dtype) @ p["wo"]
