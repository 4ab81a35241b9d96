"""GQA attention block wired to the UniCAIM cache — the port of
`repro/models/attention_layer.py` (training, prefill, chunked prefill and
decode), and the encoder-decoder's attention: the encoder's bidirectional
attention, the cross K/V made once from the encoder output, and the
decoder's cross-attention over it (plain PyTorch, as the reference's is
plain XLA)."""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PruneConfig
from repro_torch.core.attention import decode_attention, prefill_chunk_attend
from repro_torch.core.cache import KVCache
from repro_torch.core.pruning import prefill_and_prune
from repro_torch.kernels import ops
from repro_torch.models.layers import rope
from repro_torch.runtime import sharding


def _qkv(p, x: torch.Tensor, cols=(slice(None),) * 3):
    """The three projections of x, each with its bias where the config has
    one (`qkv_bias`: bq, bk, bv, added before RoPE). `cols`: the columns
    of wq, wk and wv (and their biases) to project, as slices (views of
    the weights: a rank's heads)."""
    return tuple(x @ p[w][..., c] + p[b][..., c] if b in p
                 else x @ p[w][..., c]
                 for (w, b), c in zip((("wq", "bq"), ("wk", "bk"),
                                       ("wv", "bv")), cols))


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig, positions):
    """x: [B,T,d] → q [B,Hq,T,dh], k/v [B,Hk,T,dh] (RoPE applied)."""
    b, t, _ = x.shape
    q, k, v = _qkv(p, x)
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, t, cfg.n_kv_heads, cfg.head_dim)
    if cfg.pos == "rope":
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attention_train(p, x: torch.Tensor, cfg: ModelConfig, positions,
                    causal: bool = True, chunk: int = 0) -> torch.Tensor:
    """Full-sequence attention with a gradient (training, or the encoder).
    x: [B,T,d] → y [B,T,d]. A causal call runs `ops.causal_attention` (the
    `flash_prefill` kernel forward and the `flash_prefill_bwd` kernel
    backward on the card); a non-causal one the encoder's dense f32
    bidirectional attention, plain PyTorch as the reference's is plain
    XLA."""
    b, t, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    if not causal:
        return _dense_attend(q, k, v, cfg).to(x.dtype) @ p["wo"]
    chunk = chunk or cfg.attn_chunk
    out = ops.causal_attention(q, k, v, chunk=min(chunk, t),
                               out_dtype=x.dtype)
    out = out.transpose(1, 2).reshape(b, t, cfg.q_dim)
    return out @ p["wo"]


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
    at each lane's position `cache.step`. On a block of kv-heads
    (`cache.heads`) the projections of its heads only: Hk the block's,
    Hq its G-fold."""
    b, _ = x.shape
    hk, dh = cache.k.shape[1], cfg.head_dim
    g = cfg.n_heads // cfg.n_kv_heads
    h0 = 0 if cache.heads is None else cache.heads.offset
    cols = (slice(h0 * g * dh, (h0 + hk) * g * dh),
            slice(h0 * dh, (h0 + hk) * dh), slice(h0 * dh, (h0 + hk) * dh))
    q, k, v = _qkv(p, x, cols)
    q = q.reshape(b, hk * g, dh)
    k = k.reshape(b, hk, dh)
    v = v.reshape(b, hk, dh)
    if cfg.pos == "rope":
        pos = cache.step[:, None]                           # [B,1]
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def attention_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: KVCache,
                     prune: PruneConfig,
                     active: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One decode step, writing `cache` (views of one layer of the stacked
    cache) in place. x: [B,d] → y [B,d]. On a block of kv-heads
    (`cache.heads`) the rank attends with its heads and all-gathers the
    outputs over the head ranks before `wo`, so y is the whole step's."""
    b = x.shape[0]
    q, k, v = decode_qkv(p, x, cfg, cache)
    out = decode_attention(cache, q, k, v, prune, active).reshape(b, -1)
    if cache.heads is not None:
        out = sharding.gather_blocks(out, cache.heads).transpose(0, 1)
    return out.reshape(b, cfg.q_dim).to(x.dtype) @ p["wo"]


# ---------------------------------------------------------------------------
# The encoder-decoder (whisper): dense f32 attention, no cache, no pruning
# ---------------------------------------------------------------------------


def _dense_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: ModelConfig) -> torch.Tensor:
    """Every query row over every K/V row, the reference's way: q
    [B,Hq,T,dh] grouped onto k/v [B,Hk,S,dh], f32 logits / sqrt(dh), a
    softmax and p·v in f32 → [B,T,q_dim] f32."""
    b, _, t, dh = q.shape
    qg = q.reshape(b, cfg.n_kv_heads, -1, t, dh).float()
    logits = torch.einsum("bhgtd,bhsd->bhgts", qg,
                          k.float()) / math.sqrt(dh)
    pr = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhgts,bhsd->bhgtd", pr, v.float())
    return out.reshape(b, cfg.n_heads, t, dh).transpose(1, 2).reshape(
        b, t, cfg.q_dim)


def encode_cross_kv(p, enc_out: torch.Tensor, cfg: ModelConfig):
    """One decoder layer's cross K/V from the encoder output [B,S,d]: k, v
    [B,Hk,S,dh] with their biases, in the encoder output's dtype."""
    b, s, _ = enc_out.shape

    def proj(w, bias):
        y = enc_out @ p[w] + p[bias] if bias in p else enc_out @ p[w]
        return y.reshape(b, s, cfg.n_kv_heads, cfg.head_dim).transpose(1, 2)

    return proj("wk", "bk"), proj("wv", "bv")


def cross_attention(p, x: torch.Tensor, enc_kv, cfg: ModelConfig
                    ) -> torch.Tensor:
    """Cross-attention of x [B,T,d] (a decode step's [B,1,d]) over the
    encoder's K/V (k, v [B,Hk,S,dh]): q with its bias, no bias on wo →
    y [B,T,d]."""
    b, t, _ = x.shape
    q = x @ p["wq"] + p["bq"] if "bq" in p else x @ p["wq"]
    q = q.reshape(b, t, cfg.n_heads, cfg.head_dim).transpose(1, 2)
    return _dense_attend(q, *enc_kv, cfg).to(x.dtype) @ p["wo"]
