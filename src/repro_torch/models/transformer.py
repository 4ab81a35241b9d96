"""The model — the port of `repro/models/transformer.py` for the dense
family (RMS norm or LayerNorm; SwiGLU, tanh-GELU or relu²; an optional qkv
bias; the vision frontend stub), the MoE family (routed experts in every
block, `models/moe.py`), the mla_moe family (deepseek-v3: MLA latent
attention, `models/mla.py`, over dense-FFN blocks then MoE blocks), the SSM
family (mamba2: Mamba2 SSD blocks, `models/ssm.py`) and the hybrid
(zamba2: SSD blocks with ONE shared attention block applied before every
`attn_period` of them, its weights reused and a cache of its own at each
application) and the encoder-decoder (whisper: a bidirectional encoder over
`batch["enc_embed"]`, then decoder blocks of pruned causal self-attention
on the cache, cross-attention over K/V made once from the encoder output,
and the MLP; sinusoidal positions on both stacks). A
multi-token-prediction head (`mtp_depth > 0`, deepseek-v3's) is built with
the reference's tree; training reads it (`train_outputs`' "mtp_logits"),
serving does not.

`Model` keeps the reference's functional surface: parameters are nested
dicts of tensors with the reference's key names (`embed`, `final_norm`,
`lm_head`, `frontend_adapter`, `mtp`, and the segments — `seg0_dense`,
`seg0_moe`, `seg0_ssm`, `seg0_mla_dense` and `seg1_mla_moe`, or
`seg0_encdec_enc` and `seg1_encdec_dec` (whose blocks add `ln_x` and
`xattn`) — stacked on a leading layer axis; the hybrid's `ssm_groups`
[n_groups, attn_period, ...], `ssm_tail` [rem, ...] and one unstacked
`shared_attn` block), and

  prefill(params, batch)           → (last-valid-position logits, state)
  prefill_one / prefill_group      → the same for one request / a padded
                                     admission group
  prefill_chunk(params, pstate, tok_c, row0, length) → one slice of a
      time-sliced prefill into a `PrefillChunkState` workspace;
      prefill_finalize(...) → the static pruning and the logits after it
  decode_step(params, state, tok)  → (logits, state)
  train_hidden / train_logits / train_outputs(params, batch)
                                   → the training forward with a gradient

The decode state's layer-stacked cache and SSM state are updated in place
(the enc-dec's cross K/V is written once, by the prefill):
each layer writes its token through views of its slice (`KVCache.layer`,
`SSMState.layer`), so no step copies the state. Eager PyTorch needs neither
the reference's layer scan nor its decode window: the kernel skips the
dead slot blocks itself.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils import checkpoint as torch_checkpoint

from repro_torch.configs.base import ModelConfig, PruneConfig
from repro_torch.core import attention
from repro_torch.core import cache as kvcache
from repro_torch.core.cache import KVCache, init_cache
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention_layer import (attention_decode,
                                                attention_prefill,
                                                attention_prefill_chunk,
                                                attention_train,
                                                cross_attention,
                                                encode_cross_kv)
from repro_torch.models.mla import (init_mla, mla_decode, mla_prefill,
                                    mla_train)
from repro_torch.models.moe import apply_moe, apply_moe_ep_shardmap, init_moe
from repro_torch.models.ssm import (SSMState, init_ssm, init_ssm_state,
                                    ssm_decode, ssm_prefill, ssm_train)
from repro_torch.runtime import sharding

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclass
class DecodeState:
    kv: Optional[KVCache] = None     # stacked [L_attn, B, Hk, S, ·] (MLA:
    #                                  the latent, Hk = 1, no V); None for
    #                                  an SSM model
    ssm: Optional[SSMState] = None   # stacked [L_ssm, B, ...] f32 (ssm and
    #                                  hybrid families)
    cross: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    #                                  enc-dec: the decoder's cross (k, v),
    #                                  each [L_dec, B, Hk, S_enc, dh] in the
    #                                  compute dtype, never quantized

    def clone(self) -> "DecodeState":
        return DecodeState(
            *(None if x is None else x.clone() for x in (self.kv, self.ssm)),
            cross=_map_cross(self.cross, torch.clone))


def _map_cross(cross, fn):
    return None if cross is None else tuple(fn(a) for a in cross)


@dataclass
class PrefillChunkState:
    """Workspace of a time-sliced (chunked) prefill: per-layer prompt K/V
    buffers in the compute dtype and the running column sums, sized to the
    prompt's bucket. Chunks write rows [row0, row0+C) and add their column
    sums in place; `Model.prefill_finalize` then runs the one-shot static
    pruning over the full buffers."""
    k: torch.Tensor                  # [L, B, Hk, N_bucket, dh]
    v: torch.Tensor                  # [L, B, Hk, N_bucket, dv]
    acc: torch.Tensor                # [L, B, Hk, N_bucket] f32


def lane_slice(state: DecodeState, lane: int) -> DecodeState:
    """One lane of a batched state as a batch-1 state (a copy)."""
    return DecodeState(
        kv=(None if state.kv is None
            else kvcache.lane_slice(state.kv, lane, batch_axis=1)),
        ssm=(None if state.ssm is None else state.ssm.map(
            lambda a: a.narrow(1, lane, 1).clone())),
        cross=_map_cross(state.cross,
                         lambda a: a.narrow(1, lane, 1).clone()))


def lane_insert(state: DecodeState, lane: int,
                fresh: DecodeState) -> DecodeState:
    """In place: lane `lane` of `state` takes the batch-1 `fresh` state
    (e.g. from `prefill_one`, or a prefix-cache snapshot)."""
    if state.kv is not None:
        kvcache.lane_insert(state.kv, lane, fresh.kv, batch_axis=1)
    pairs = []
    if state.ssm is not None:
        pairs += [(state.ssm.conv, fresh.ssm.conv),
                  (state.ssm.ssm, fresh.ssm.ssm)]
    if state.cross is not None:
        pairs += zip(state.cross, fresh.cross)
    for a, f in pairs:
        a.narrow(1, lane, 1).copy_(f)
    return state


def lane_select(active: torch.Tensor, new: DecodeState,
                old: DecodeState) -> DecodeState:
    """Per-lane merge: lanes where `active` ([B] bool) take `new`, the rest
    keep `old` (a new state). The cross K/V is `new`'s: a decode step never
    writes it."""
    def sel(n, o):
        m = active.reshape((1, -1) + (1,) * (n.dim() - 2))
        return torch.where(m, n, o)
    kv = None if new.kv is None else KVCache(*(
        None if getattr(new.kv, f) is None
        else sel(getattr(new.kv, f), getattr(old.kv, f))
        for f in kvcache.FIELDS))
    ssm = None if new.ssm is None else SSMState(
        sel(new.ssm.conv, old.ssm.conv), sel(new.ssm.ssm, old.ssm.ssm))
    return DecodeState(kv=kv, ssm=ssm, cross=new.cross)


def lanes_insert(state: DecodeState, src, fresh: DecodeState) -> DecodeState:
    """In place: lane b of `state` takes row `src[b]` of the batch-G
    `fresh` state where `src[b] >= 0` (grouped admission)."""
    if state.kv is not None:
        kvcache.lanes_insert(state.kv, src, fresh.kv, batch_axis=1)
    lanes = [b for b, r in enumerate(src) if r >= 0]
    pairs = []
    if state.ssm is not None:
        pairs += [(state.ssm.conv, fresh.ssm.conv),
                  (state.ssm.ssm, fresh.ssm.ssm)]
    if state.cross is not None:
        pairs += zip(state.cross, fresh.cross)
    if pairs and lanes:
        dev = pairs[0][0].device
        dst = torch.as_tensor(lanes, dtype=torch.long, device=dev)
        rows = torch.as_tensor([int(src[b]) for b in lanes],
                               dtype=torch.long, device=dev)
        for a, f in pairs:
            a.index_copy_(1, dst, f.index_select(1, rows).to(a.dtype))
    return state


def _store_layer(state: DecodeState, li: int, filled: KVCache) -> None:
    """Copy a filled one-layer cache into layer `li` of the stacked state."""
    dst = state.kv.layer(li)
    for name in kvcache.FIELDS:
        if getattr(dst, name) is not None:
            getattr(dst, name).copy_(getattr(filled, name))


def layer_params(params_seg, li: int):
    """Layer `li`'s parameters out of a stacked segment (views); lists (the
    shared experts) keep their nesting."""
    if isinstance(params_seg, dict):
        return {k: layer_params(v, li) for k, v in params_seg.items()}
    if isinstance(params_seg, list):
        return [layer_params(v, li) for v in params_seg]
    return params_seg[li]


def _block_train(p, x: torch.Tensor, cfg: ModelConfig, positions, kind: str,
                 cross_kv=None, causal: bool = True):
    """One residual block over the whole sequence, with a gradient →
    (x, aux): an SSD block (`ssm`), or attention (MLA's `mla_train` for
    the `mla_*` kinds, else causal through the kernels' op, `causal=False`
    for the encoder), the decoder's cross-attention over `cross_kv`
    (`encdec_dec`), and the MLP or the routed experts, whose
    load-balancing loss is the aux (a zero f32 scalar elsewhere)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if kind == "ssm":
        return x + ssm_train(p["ssm"], L.apply_norm(p["norm"], x, cfg.norm),
                             cfg), aux
    h = L.apply_norm(p["ln1"], x, cfg.norm)
    if kind.startswith("mla"):
        x = x + mla_train(p["attn"], h, cfg, positions)
    else:
        x = x + attention_train(p["attn"], h, cfg, positions, causal=causal)
    if kind == "encdec_dec":
        x = x + cross_attention(p["xattn"],
                                L.apply_norm(p["ln_x"], x, cfg.norm),
                                cross_kv, cfg)
    h = L.apply_norm(p["ln2"], x, cfg.norm)
    if "moe" in p:
        y, aux = _moe(p["moe"], h, cfg)
    else:
        y = L.apply_mlp(p["mlp"], h, cfg.act)
    return x + y, aux


def _moe(pm, h: torch.Tensor, cfg: ModelConfig):
    """MoE dispatch: expert parallelism over the active process mesh's
    `model` axis when `cfg.moe_ep` is set and the experts divide it
    (`apply_moe_ep_shardmap`); the sort-based dispatch otherwise."""
    if cfg.moe_ep:
        mesh = sharding.active_process_mesh()
        if (mesh is not None and "model" in mesh.shape
                and cfg.moe.n_experts % mesh.shape["model"] == 0):
            return apply_moe_ep_shardmap(pm, h, cfg, mesh)
    return apply_moe(pm, h, cfg)


def _save_products(ctx, op, *args, **kwargs):
    """The selective-checkpoint policy of `remat_policy="dots"`: keep the
    matrix products' outputs, recompute the rest (the reference's
    `dots_with_no_batch_dims_saveable`)."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.bmm.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _depth(tree) -> int:
    """The leading (layer) axis of a stacked segment."""
    while isinstance(tree, (dict, list)):
        tree = next(iter(tree.values())) if isinstance(tree, dict) \
            else tree[0]
    return tree.shape[0]


class Model:
    """Model facade for the dense, MoE, mla_moe, SSM, hybrid and enc-dec
    families (functional: params are passed in). `remat` recomputes each
    block's activations in the backward (training only): `remat_policy`
    "nothing" keeps none of them, "dots" keeps the matrix products'
    outputs."""

    def __init__(self, cfg: ModelConfig, prune: PruneConfig, device="cuda",
                 remat: bool = False, remat_policy: str = "nothing"):
        unsupported = [name for name, bad in (
            ("family", cfg.family not in ("dense", "moe", "mla_moe", "ssm",
                                          "hybrid", "encdec")),
            ("pos", cfg.pos not in ("rope", "sinusoidal", "none"))) if bad]
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unsupported)} not ported "
                "(the port serves the dense, MoE, mla_moe, SSM, hybrid and "
                "enc-dec families)")
        if remat_policy not in ("nothing", "dots"):
            raise ValueError(f"remat_policy {remat_policy!r}: 'nothing' or "
                             "'dots'")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.prune = prune
        self.remat = remat
        self.remat_policy = remat_policy

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.compute_dtype]

    # -- segments -----------------------------------------------------------

    def _segments(self):
        """[(kind, n_layers)] of the stack, as in the reference: one
        segment of `dense`, `moe` or `ssm` blocks, for mla_moe the first
        `dense_first_k` blocks as `mla_dense` and the rest as `mla_moe`,
        for enc-dec the encoder's `encdec_enc` blocks then the decoder's
        `encdec_dec` blocks (the hybrid's stack is its groups,
        `_blocks`)."""
        cfg = self.cfg
        if cfg.family == "mla_moe":
            k = cfg.moe.dense_first_k
            return [("mla_dense", k), ("mla_moe", cfg.num_layers - k)]
        if cfg.family == "encdec":
            return [("encdec_enc", cfg.enc_layers),
                    ("encdec_dec", cfg.dec_layers)]
        return [(cfg.family, cfg.num_layers)]

    def attn_layer_count(self) -> int:
        """Layers of the decode state's KV cache: none for an SSM model, one
        per application of the hybrid's shared block, one per decoder block
        of an enc-dec model, else one a block."""
        cfg = self.cfg
        if cfg.family == "ssm":
            return 0
        if cfg.family == "hybrid":
            return cfg.num_layers // cfg.attn_period
        if cfg.family == "encdec":
            return cfg.dec_layers
        return cfg.num_layers

    def _blocks(self, params):
        """(block kind, its parameters, its KV-cache layer, its SSM-state
        layer) over the stack in order; the unused index is None. The
        hybrid's group g runs `shared_attn` on KV layer g, then its
        `attn_period` SSD blocks on SSM layers g·period …; the tail's SSD
        blocks follow. An enc-dec model's stack is its decoder (`_encode`
        runs the encoder)."""
        cfg = self.cfg
        if cfg.family == "hybrid":
            period = cfg.attn_period
            n_groups = cfg.num_layers // period
            for g in range(n_groups):
                yield "dense", params["shared_attn"], g, None
                group = layer_params(params["ssm_groups"], g)
                for j in range(period):
                    yield "ssm", layer_params(group, j), None, g * period + j
            for r in range(cfg.num_layers - n_groups * period):
                yield ("ssm", layer_params(params["ssm_tail"], r), None,
                       n_groups * period + r)
            return
        li = 0
        for i, (kind, n) in enumerate(self._segments()):
            if n == 0 or kind == "encdec_enc":
                continue
            seg = params[f"seg{i}_{kind}"]
            for j in range(n):
                ai, si = (None, li) if kind == "ssm" else (li, None)
                yield kind, layer_params(seg, j), ai, si
                li += 1

    # -- init ---------------------------------------------------------------

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from `seed`, made on the model's device, with the
        reference's distributions (N(0, 1/d_in) projections, N(0, 0.02²)
        embeddings, unit norms, zero biases; the MoE router in f32) and its
        tree, the `mtp` head's (`proj`, `norm`, one unstacked block) and a
        frontend model's `frontend_adapter` included (an enc-dec model
        holds it too, and never reads it). The reference's JAX draws
        differ; use `params.from_reference` to run the same weights on
        both sides. On `meta` the tree holds shapes and dtypes and no
        storage (a generator cannot live there: the draws name a CPU one
        and make nothing)."""
        cfg = self.cfg
        dt = DTYPES[cfg.param_dtype]
        dev = self.device
        gen = torch.Generator(device="cpu" if dev.type == "meta" else dev)
        gen.manual_seed(seed)
        d = cfg.d_model
        params: Dict[str, Any] = {
            "embed": L.embed_init(gen, cfg.vocab_size, d, dt, dev),
            "final_norm": L.norm_init(cfg.norm, d, dt, dev),
        }
        if cfg.family == "hybrid":
            period = cfg.attn_period
            n_groups = cfg.num_layers // period
            rem = cfg.num_layers - n_groups * period
            params["ssm_groups"] = self._init_block(gen, "ssm", dt,
                                                    (n_groups, period))
            if rem:
                params["ssm_tail"] = self._init_block(gen, "ssm", dt, (rem,))
            params["shared_attn"] = self._init_block(gen, "dense", dt, ())
        else:
            for i, (kind, n) in enumerate(self._segments()):
                if n:
                    params[f"seg{i}_{kind}"] = self._init_block(gen, kind, dt,
                                                                (n,))
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, d, cfg.vocab_size, dt, dev)
        if cfg.frontend != "none":
            params["frontend_adapter"] = L.dense_init(gen, d, d, dt, dev)
        if cfg.mtp_depth > 0:
            params["mtp"] = {
                "proj": L.dense_init(gen, 2 * d, d, dt, dev),
                "norm": L.norm_init(cfg.norm, d, dt, dev),
                "block": self._init_block(
                    gen, "mla_dense" if cfg.mla else "dense", dt, ())}
        return params

    def _init_block(self, gen: torch.Generator, kind: str, dt, lead):
        """Residual blocks of `kind` (dense | moe | mla_dense | mla_moe |
        ssm | encdec_enc | encdec_dec), stacked on the leading axes `lead`
        (`()`: one block). The dense blocks of a MoE config take its
        `d_ff_dense`; a decoder block adds `ln_x` and the cross-attention
        `xattn`."""
        cfg = self.cfg
        dev, d, lead = self.device, cfg.d_model, tuple(lead)
        if kind == "ssm":
            return {"norm": L.norm_init(cfg.norm, d, dt, dev, lead),
                    "ssm": init_ssm(gen, cfg, dt, dev, lead)}

        def dense(d_in, d_out):
            return L.dense_init(gen, d_in, d_out, dt, dev, lead=lead)

        def zeros(width):
            return torch.zeros(lead + (width,), dtype=dt, device=dev)

        def attention():
            attn = {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
                    "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)}
            if cfg.qkv_bias:
                attn.update(bq=zeros(cfg.q_dim), bk=zeros(cfg.kv_dim),
                            bv=zeros(cfg.kv_dim))
            return attn

        block = {"ln1": L.norm_init(cfg.norm, d, dt, dev, lead),
                 "ln2": L.norm_init(cfg.norm, d, dt, dev, lead),
                 "attn": (init_mla(gen, cfg, dt, dev, lead)
                          if kind.startswith("mla") else attention())}
        if kind == "encdec_dec":
            block["ln_x"] = L.norm_init(cfg.norm, d, dt, dev, lead)
            block["xattn"] = attention()
        if kind.endswith("moe"):
            block["moe"] = init_moe(gen, cfg, dt, dev, lead)
        else:
            d_ff = cfg.d_ff if cfg.moe is None else cfg.moe.d_ff_dense
            block["mlp"] = L.mlp_init(gen, d, d_ff or cfg.d_ff, cfg.act, dt,
                                      dev, lead)
        return block

    # -- state --------------------------------------------------------------

    def init_decode_state(self, batch_size: int,
                          cross_len: int = 0) -> DecodeState:
        """An empty layer-stacked state: a cache of `attn_layer_count()`
        layers (per kv-head K/V, or for MLA the latent: Hk = 1, width
        `latent_dim`, no V), for the SSM and hybrid families an f32 SSM
        state a block, and for an enc-dec model with `cross_len` > 0 the
        cross K/V over that many encoder rows, zero until `prefill`'s
        encoder writes it."""
        cfg = self.cfg
        kv = ssm = cross = None
        n_attn = self.attn_layer_count()
        if n_attn:
            if cfg.mla is not None:
                heads, width = 1, cfg.mla.latent_dim
            else:
                heads, width = cfg.n_kv_heads, cfg.head_dim
            kv = init_cache(batch_size, heads, width, self.prune.slots,
                            self.prune, self.dtype, device=self.device,
                            layers=n_attn, latent=cfg.mla is not None)
        if cfg.family in ("ssm", "hybrid"):
            ssm = init_ssm_state(cfg, batch_size, device=self.device,
                                 layers=cfg.num_layers)
        if cfg.family == "encdec" and cross_len > 0:
            shape = (cfg.dec_layers, batch_size, cfg.n_kv_heads, cross_len,
                     cfg.head_dim)
            cross = tuple(torch.zeros(shape, dtype=self.dtype,
                                      device=self.device) for _ in range(2))
        return DecodeState(kv=kv, ssm=ssm, cross=cross)

    # -- shared pieces ------------------------------------------------------

    def _mesh_layout(self, batch_size: int):
        """This rank's `Layout` of the decode state under the active process
        mesh (`core.attention.state_layout`, the reference's
        `decode_state_pspecs`); None without one or where nothing splits.
        Refuses the families the layout does not take yet, before any
        work."""
        mesh = sharding.active_process_mesh()
        if mesh is None:
            return None
        cfg = self.cfg
        n_attn = self.attn_layer_count()
        layout = None if not n_attn else attention.state_layout(
            mesh, (n_attn, batch_size, cfg.n_kv_heads if cfg.mla is None
                   else 1, self.prune.slots, cfg.head_dim))
        if layout is not None or not n_attn:
            attention.check_layout_family(
                cfg.mla is not None, cfg.family in ("ssm", "hybrid"),
                cfg.family == "encdec")
        return layout

    def _laid_out_state(self, batch_size: int, layout) -> DecodeState:
        """An empty state of this rank's block under `layout`."""
        cfg = self.cfg
        blocks = [batch_size, cfg.n_kv_heads, self.prune.slots]
        for i, blk in enumerate(layout):
            if blk is not None:
                blocks[i] //= sharding.group_size(blk.group)
        kv = init_cache(blocks[0], blocks[1], cfg.head_dim, blocks[2],
                        self.prune, self.dtype, device=self.device,
                        layers=self.attn_layer_count())
        kv.rows, kv.heads, kv.shard = layout
        return DecodeState(kv=kv)

    def _prompt_state(self, b: int, cross_len: int = 0):
        """(the state a prompt pass fills, the one-layer cache each layer's
        static pruning fills first): a whole state (and None), filled
        through views of its layers; or, under an active process mesh that
        lays it out, this rank's block and ONE whole layer's empty cache,
        each filled layer cut to the block (`_store_prompt_layer`)."""
        layout = self._mesh_layout(b)
        if layout is None:
            return self.init_decode_state(b, cross_len=cross_len), None
        whole = init_cache(b, self.cfg.n_kv_heads, self.cfg.head_dim,
                           self.prune.slots, self.prune, self.dtype,
                           device=self.device)
        return self._laid_out_state(b, layout), whole

    @staticmethod
    def _store_prompt_layer(state: DecodeState, li: int, filled: KVCache,
                            whole: Optional[KVCache]) -> None:
        """Store a layer's filled cache, cut to the state's block when the
        prompt pass filled a `whole` one."""
        if whole is not None:
            kv = state.kv
            filled = attention.cut_cache(filled, (kv.rows, kv.heads,
                                                  kv.shard))
        _store_layer(state, li, filled)

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """The final norm and the head, in f32."""
        x = L.apply_norm(params["final_norm"], x, self.cfg.norm)
        return x.float() @ self.head_matrix(params).float()

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(self.dtype)

    def _add_positions(self, x: torch.Tensor, pos) -> torch.Tensor:
        """x plus the sinusoidal table at `pos` for a sinusoidal config (a
        RoPE config rotates q and k in the attention instead)."""
        if self.cfg.pos != "sinusoidal":
            return x
        return x + L.sinusoidal(pos, self.cfg.d_model).to(x.dtype)

    def _prepend_frontend(self, params, batch, x: torch.Tensor):
        """The frontend stub: batch["<frontend>_embed"] [B, F, d] through
        the adapter, in front of the token embeddings → (x, F). An enc-dec
        model's frontend feeds its encoder instead (`_encode`)."""
        cfg = self.cfg
        if cfg.frontend == "none" or cfg.family == "encdec":
            return x, 0
        key = f"{cfg.frontend}_embed"
        if batch.get(key) is None:
            raise ValueError(f"{cfg.name} takes batch[{key!r}] (its "
                             f"{cfg.frontend} frontend's embeddings)")
        emb = torch.as_tensor(batch[key], device=self.device).to(x.dtype)
        emb = emb @ params["frontend_adapter"]
        return torch.cat([emb, x], dim=1), emb.shape[1]

    def _ffn(self, p, h: torch.Tensor) -> torch.Tensor:
        """The block's feed-forward on h ([B, T, d], or a decode step's
        [B, d]): the routed experts of a moe block (the aux loss is a
        training quantity), else the MLP. A decode step routes its B lanes'
        tokens together, as the reference's [B, 1, d] call does."""
        if "moe" in p:
            y, _ = _moe(p["moe"], h.reshape(h.shape[0], -1, h.shape[-1]),
                        self.cfg)
            return y.reshape(h.shape)
        return L.apply_mlp(p["mlp"], h, self.cfg.act)

    def _encode(self, params, batch, cross) -> Tuple[torch.Tensor,
                                                     torch.Tensor]:
        """The enc-dec's encoder over batch["enc_embed"] ([B, S, d], the
        frontend stub's frames) plus its sinusoidal positions: LayerNorm →
        bidirectional attention → LayerNorm → MLP a block; then each
        decoder layer's cross K/V from the output, written into `cross`
        ((k, v), each [L_dec, B, Hk, S, dh] in the compute dtype: a state's,
        from `init_decode_state(B, cross_len=S)`) → `cross`."""
        enc, _ = self._encoder(params, batch)
        dec = params["seg1_encdec_dec"]
        for j in range(self.cfg.dec_layers):
            cross[0][j], cross[1][j] = encode_cross_kv(
                layer_params(dec, j)["xattn"], enc, self.cfg)
        return cross

    def _encoder(self, params, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """The enc-dec's encoder blocks over batch["enc_embed"] plus its
        sinusoidal positions → (its output [B, S, d], the blocks' aux, a
        zero f32 scalar)."""
        cfg = self.cfg
        enc = torch.as_tensor(batch["enc_embed"],
                              device=self.device).to(self.dtype)
        pos = torch.arange(enc.shape[1], device=self.device)[None]
        enc = enc + L.sinusoidal(pos, cfg.d_model).to(enc.dtype)
        return self._scan_train(params["seg0_encdec_enc"], enc, pos,
                                "encdec_enc", causal=False)

    def _cross_attend(self, p, x: torch.Tensor, cross, li: int
                      ) -> torch.Tensor:
        """A decoder block's cross-attention sublayer on x ([B, T, d], or a
        decode step's [B, d]) over layer `li` of the cross K/V: the
        residual's increment."""
        h = L.apply_norm(p["ln_x"], x, self.cfg.norm)
        y = cross_attention(p["xattn"], h if h.dim() == 3 else h[:, None],
                            (cross[0][li], cross[1][li]), self.cfg)
        return y.reshape(x.shape)

    # -- prefill --------------------------------------------------------------

    def prefill(self, params, batch) -> Tuple[torch.Tensor, DecodeState]:
        """Prompt pass with one-shot static pruning → (logits [B,V] at the
        last valid position, DecodeState).

        `batch["length"]` ([B] int32, optional) marks the true lengths of
        prompts right-padded to a shared bucket: pads neither attend,
        accumulate, nor enter the static top-k. The SSM and hybrid
        families refuse it (their recurrent state would absorb the pads).
        A frontend model takes `batch["<frontend>_embed"]` ([B, F, d]): its
        F rows sit in front of the tokens and are always valid, so the
        cache holds F + length positions. An enc-dec model takes
        `batch["enc_embed"]` ([B, S, d]) for its encoder, refuses a
        `length`, and its state carries the cross K/V.

        Under an active process mesh whose `decode_state_pspecs` split the
        state (`core.attention.state_layout`), every rank computes the
        whole prompt pass and keeps its block of each layer's cache, cut
        right after the layer's static pruning: the returned state is the
        rank's block (`decode_step` gathers its outputs), the logits the
        whole batch's."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        length = batch.get("length")
        cross_len = 0
        if cfg.family == "encdec":
            if length is not None:
                raise ValueError("bucketed prefill: encdec unsupported")
            if batch.get("enc_embed") is None:
                raise ValueError(f"{cfg.name} takes batch['enc_embed'] (its "
                                 "encoder's input frames)")
            cross_len = batch["enc_embed"].shape[1]
        if length is not None and cfg.family in ("ssm", "hybrid"):
            raise ValueError(
                f"bucketed prefill: {cfg.family} carries recurrent state "
                "that right-padded tokens would pollute")
        if length is not None:
            length = torch.as_tensor(length, dtype=torch.int32,
                                     device=self.device)
        b = tokens.shape[0]
        x, n_front = self._prepend_frontend(params, batch,
                                            self._embed(params, tokens))
        eff_len = None if length is None else length + n_front
        pos = torch.arange(x.shape[1], device=self.device)[None]
        x = self._add_positions(x, pos)
        state, whole = self._prompt_state(b, cross_len)
        if cross_len:
            self._encode(params, batch, state.cross)
        for kind, p, li, si in self._blocks(params):
            if kind == "ssm":
                h = L.apply_norm(p["norm"], x, cfg.norm)
                x = x + ssm_prefill(p["ssm"], h, cfg, state.ssm.layer(si))
                continue
            h = L.apply_norm(p["ln1"], x, cfg.norm)
            attend = mla_prefill if kind.startswith("mla") \
                else attention_prefill
            a, filled = attend(p["attn"], h, cfg, pos, self.prune,
                               state.kv.layer(li) if whole is None else whole,
                               length=eff_len)
            self._store_prompt_layer(state, li, filled, whole)
            x = x + a
            if kind == "encdec_dec":
                x = x + self._cross_attend(p, x, state.cross, li)
            x = x + self._ffn(p, L.apply_norm(p["ln2"], x, cfg.norm))
        if length is None:
            x_last = x[:, -1]
        else:  # last *valid* position per lane, not the bucket's last pad
            x_last = x[torch.arange(b, device=self.device),
                       eff_len.long() - 1]
        return self._logits(params, x_last), state

    def prefill_one(self, params, tokens, length=None
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """One request: tokens [t] (right-padded to a bucket with its true
        `length`, optional) → (logits [V], batch-1 state) for
        `lanes_insert`."""
        batch = {"tokens": torch.as_tensor(tokens, device=self.device)[None]}
        if length is not None:
            batch["length"] = torch.as_tensor(
                length, dtype=torch.int32, device=self.device).reshape(1)
        logits, state = self.prefill(params, batch)
        return logits[0], state

    def prefill_group(self, params, tokens, lengths=None
                      ) -> Tuple[torch.Tensor, DecodeState]:
        """Batched admission prefill: G prompts padded to one bucket
        ([G, W] tokens, [G] true lengths) in one pass → (logits [G, V],
        batch-G state) for `lanes_insert`."""
        batch = {"tokens": tokens}
        if lengths is not None:
            batch["length"] = lengths
        return self.prefill(params, batch)

    # -- chunked (time-sliced) prefill ----------------------------------------

    def supports_bucketed_prefill(self) -> bool:
        """Right-padded, length-masked prefill needs an attention-only
        prompt pass: not the SSM and hybrid families (nor enc-dec), whose
        recurrent state would absorb the pads."""
        return self.cfg.family not in ("ssm", "hybrid", "encdec")

    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill covers the plain attention stacks (dense and
        MoE); an MLA model, a frontend model and the recurrent (SSM and
        hybrid) families admit their prompts whole, as in the
        reference."""
        cfg = self.cfg
        return (cfg.family in ("dense", "moe") and cfg.mla is None
                and cfg.frontend == "none")

    def init_prefill_chunk_state(self, batch_size: int,
                                 bucket: int) -> PrefillChunkState:
        """Empty workspace for prompts padded to `bucket`."""
        cfg = self.cfg
        assert self.supports_chunked_prefill(), cfg.name
        shape = (cfg.num_layers, batch_size, cfg.n_kv_heads, bucket,
                 cfg.head_dim)
        return PrefillChunkState(
            k=torch.zeros(shape, dtype=self.dtype, device=self.device),
            v=torch.zeros(shape, dtype=self.dtype, device=self.device),
            acc=torch.zeros(shape[:4], dtype=torch.float32,
                            device=self.device))

    def resume_prefill_chunk_state(self, k_rows, v_rows, acc_rows,
                                   bucket: int) -> PrefillChunkState:
        """Batch-1 workspace over `bucket` whose rows [0, p) come from an
        earlier chunked prefill of the same tokens: k_rows / v_rows
        [L, Hk, p, dh], acc_rows [L, Hk, p] f32, as that prefill held them
        after its first p / C chunks. Chunks then run from row p on; the
        columns a chunk does not reach take no mass from it, so the result
        equals the run from row 0."""
        pstate = self.init_prefill_chunk_state(1, bucket)
        p = int(k_rows.shape[-2])
        assert p <= bucket, (p, bucket)

        def rows(x, dtype):
            return torch.as_tensor(x, device=self.device).to(dtype)[:, None]

        pstate.k[:, :, :, :p] = rows(k_rows, pstate.k.dtype)
        pstate.v[:, :, :, :p] = rows(v_rows, pstate.v.dtype)
        pstate.acc[:, :, :, :p] = rows(acc_rows, torch.float32)
        return pstate

    def prefill_chunk(self, params, pstate: PrefillChunkState, tokens_c,
                      row0: int, length) -> Tuple[torch.Tensor,
                                                  PrefillChunkState]:
        """One prefill slice: the whole layer stack over prompt rows
        [row0, row0+C), streaming each layer's K/V and column sums into the
        workspace IN PLACE. tokens_c: [B, C]; length: [B] true prompt
        lengths. Returns (final-stack hidden [B, C, d], the workspace)."""
        cfg = self.cfg
        tokens_c = torch.as_tensor(tokens_c, device=self.device)
        length = torch.as_tensor(length, dtype=torch.int32,
                                 device=self.device)
        row0 = int(row0)
        pos = row0 + torch.arange(tokens_c.shape[1], device=self.device)[None]
        x = self._add_positions(self._embed(params, tokens_c), pos)
        for _, p, li, _ in self._blocks(params):
            h = L.apply_norm(p["ln1"], x, cfg.norm)
            a, _, _, _ = attention_prefill_chunk(
                p["attn"], h, cfg, pos, self.prune, pstate.k[li],
                pstate.v[li], pstate.acc[li], row0, length)
            x = x + a
            x = x + self._ffn(p, L.apply_norm(p["ln2"], x, cfg.norm))
        return x, pstate

    def prefill_finalize(self, params, pstate: PrefillChunkState, x_last,
                         row0: int, length) -> Tuple[torch.Tensor,
                                                     DecodeState]:
        """Finish a chunked prefill: the one-shot static pruning over the
        streamed buffers, and the logits at position length-1. x_last: the
        final chunk's hidden [B, C, d] (it holds that position); row0: its
        absolute offset. Returns (logits [B, V], DecodeState): under an
        active process mesh that lays the state out, this rank's block of
        it (as `prefill`'s)."""
        length = torch.as_tensor(length, dtype=torch.int32,
                                 device=self.device)
        b = x_last.shape[0]
        state, whole = self._prompt_state(b)
        for li in range(self.attn_layer_count()):
            self._store_prompt_layer(state, li, kvcache.prefill_fill(
                state.kv.layer(li) if whole is None else whole,
                pstate.k[li], pstate.v[li], pstate.acc[li], self.prune,
                length=length), whole)
        x_sel = x_last[torch.arange(b, device=self.device),
                       length.long() - 1 - int(row0)]
        return self._logits(params, x_sel), state

    # -- decode ---------------------------------------------------------------

    def decode_step(self, params, state: DecodeState, token: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """token: [B] → (logits [B, V] f32, state updated in place).

        `active` ([B] bool, optional) freezes the other lanes' cache rows
        and SSM state (finished lanes of a serving block). A sinusoidal
        config adds the table at each lane's position, layer 0's
        `kv.step`.

        On a state laid out over a process mesh (`prefill` under one, or
        `core.attention.shard_decode_state`), token and `active` stay the
        whole batch's: the rank computes its batch rows (`kv.rows`) with
        its kv-heads (`kv.heads`, the attention outputs gathered over the
        head ranks) and its slots (`kv.shard`, the race shared over the
        slot ranks), and the logits are all-gathered over the batch
        ranks. Weights stay whole on every rank."""
        cfg = self.cfg
        token = torch.as_tensor(token, device=self.device)
        rows = None if state.kv is None else state.kv.rows
        if rows is not None:
            b = state.kv.fill.shape[1]
            token = token[rows.offset:rows.offset + b]
            if active is not None:
                active = active[rows.offset:rows.offset + b]
        x = self._embed(params, token)
        if state.kv is not None:
            x = self._add_positions(x, state.kv.step[0])
        for kind, p, li, si in self._blocks(params):
            if kind == "ssm":
                h = L.apply_norm(p["norm"], x, cfg.norm)
                x = x + ssm_decode(p["ssm"], h, cfg, state.ssm.layer(si),
                                   active)
                continue
            h = L.apply_norm(p["ln1"], x, cfg.norm)
            attend = mla_decode if kind.startswith("mla") \
                else attention_decode
            a = attend(p["attn"], h, cfg, state.kv.layer(li), self.prune,
                       active)
            x = x + a
            if kind == "encdec_dec":
                x = x + self._cross_attend(p, x, state.cross, li)
            x = x + self._ffn(p, L.apply_norm(p["ln2"], x, cfg.norm))
        logits = self._logits(params, x)
        if rows is not None:
            logits = sharding.gather_blocks(logits, rows).reshape(
                -1, logits.shape[-1])
        return logits, state

    # -- train ----------------------------------------------------------------

    def _train_block(self, p, x: torch.Tensor, positions, kind: str,
                     cross_kv=None, causal: bool = True):
        """`_block_train`, recomputed in the backward under `remat`."""
        if not self.remat:
            return _block_train(p, x, self.cfg, positions, kind, cross_kv,
                                causal)
        kw = {}
        if self.remat_policy == "dots":
            kw["context_fn"] = functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _save_products)
        return torch_checkpoint.checkpoint(
            _block_train, p, x, self.cfg, positions, kind, cross_kv, causal,
            use_reentrant=False, **kw)

    def _scan_train(self, stacked, x: torch.Tensor, positions, kind: str,
                    cross_kv=None, causal: bool = True):
        """The blocks of a stacked segment in order (the reference's layer
        scan as a loop; `cross_kv`: a list of each decoder layer's (k, v))
        → (x, the sum of their aux losses)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for li in range(_depth(stacked)):
            x, a = self._train_block(
                layer_params(stacked, li), x, positions, kind,
                None if cross_kv is None else cross_kv[li], causal)
            aux = aux + a
        return x, aux

    def _hybrid_train(self, params, x: torch.Tensor, positions):
        """The hybrid's stack: the shared attention block before each group
        of `attn_period` SSD blocks, then the tail's SSD blocks → (x, a
        zero aux)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        groups = params["ssm_groups"]
        for g in range(_depth(groups)):
            x, _ = self._train_block(params["shared_attn"], x, positions,
                                     "dense")
            x, _ = self._scan_train(layer_params(groups, g), x, positions,
                                    "ssm")
        if "ssm_tail" in params:
            x, _ = self._scan_train(params["ssm_tail"], x, positions, "ssm")
        return x, aux

    def head_matrix(self, params) -> torch.Tensor:
        """The vocabulary projection [d, V]: the tied embedding's transpose,
        or `lm_head`."""
        return (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])

    def _train_backbone(self, params, batch) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        """The backbone over a batch of whole sequences, with a gradient →
        (pre-final-norm hidden [B, T, d], the summed aux loss, an f32
        scalar): `train_hidden` normalises it, and the MTP head of
        `train_outputs` reads it as it is (the reference's
        `_hidden_for_mtp`)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        cross = None
        if cfg.family == "encdec":
            if batch.get("enc_embed") is None:
                raise ValueError(f"{cfg.name} takes batch['enc_embed'] (its "
                                 "encoder's input frames)")
            enc, aux = self._encoder(params, batch)
            aux_total = aux_total + aux
            dec = params["seg1_encdec_dec"]
            cross = [encode_cross_kv(layer_params(dec, j)["xattn"], enc, cfg)
                     for j in range(cfg.dec_layers)]
        x, n_front = self._prepend_frontend(params, batch,
                                            self._embed(params, tokens))
        pos = torch.arange(x.shape[1], device=self.device)[None]
        x = self._add_positions(x, pos)
        if cfg.family == "hybrid":
            x, aux = self._hybrid_train(params, x, pos)
            aux_total = aux_total + aux
        else:
            for i, (kind, n) in enumerate(self._segments()):
                if n == 0 or kind == "encdec_enc":
                    continue
                x, aux = self._scan_train(params[f"seg{i}_{kind}"], x, pos,
                                          kind, cross_kv=cross)
                aux_total = aux_total + aux
        if n_front:
            x = x[:, n_front:]
        return x, aux_total

    def train_hidden(self, params, batch) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """The backbone over a batch of whole sequences, with a gradient →
        (post-final-norm hidden [B, T, d], the summed aux loss, an f32
        scalar). `batch`: `tokens` [B, T]; a frontend model's
        `<frontend>_embed` [B, F, d] (its F rows are cut from the output);
        an enc-dec model's `enc_embed` [B, S, d] for its encoder, whose
        output gives each decoder layer's cross K/V."""
        x, aux = self._train_backbone(params, batch)
        return L.apply_norm(params["final_norm"], x, self.cfg.norm), aux

    def train_logits(self, params, batch) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """→ (logits [B, T, V] f32, aux)."""
        x, aux = self._train_backbone(params, batch)
        return self._logits(params, x), aux

    def train_outputs(self, params, batch) -> Dict[str, torch.Tensor]:
        """→ {"logits", "aux"} from one backbone pass, and "mtp_logits"
        [B, T-1, V] f32 where the model has an MTP head (`mtp_depth > 0`
        and `params["mtp"]`): the pre-final-norm hidden of positions
        0 … T-2 beside the embedding of tokens 1 … T-1, through
        `mtp.proj`, one block at positions 0 … T-2 (`mla_dense` for an MLA
        model, not recomputed under remat, as the reference calls it),
        `mtp.norm` and the head, predicting token t + 2 from position t."""
        cfg = self.cfg
        x, aux = self._train_backbone(params, batch)
        out = {"logits": self._logits(params, x), "aux": aux}
        if cfg.mtp_depth > 0 and "mtp" in params:
            mtp = params["mtp"]
            tokens = torch.as_tensor(batch["tokens"], device=self.device)
            z = torch.cat([x[:, :-1], self._embed(params, tokens[:, 1:])],
                          dim=-1) @ mtp["proj"]
            pos = torch.arange(z.shape[1], device=self.device)[None]
            z, _ = _block_train(mtp["block"], z, cfg, pos,
                                "mla_dense" if cfg.mla else "dense")
            z = L.apply_norm(mtp["norm"], z, cfg.norm)
            out["mtp_logits"] = z.float() @ self.head_matrix(params).float()
        return out
