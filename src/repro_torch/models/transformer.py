"""The dense model — the port of `repro/models/transformer.py` (dense
family only).

`Model` keeps the reference's functional surface: parameters are nested
dicts of tensors with the reference's key names (`embed`, `final_norm`,
`lm_head`, and `seg0_dense` stacked on a leading layer axis), and

  prefill(params, batch)           → (last-valid-position logits, state)
  prefill_one / prefill_group      → the same for one request / a padded
                                     admission group
  prefill_chunk(params, pstate, tok_c, row0, length) → one slice of a
      time-sliced prefill into a `PrefillChunkState` workspace;
      prefill_finalize(...) → the static pruning and the logits after it
  decode_step(params, state, tok)  → (logits, state)

The decode state's layer-stacked cache is updated in place: each layer
writes its token through views of its slice (`KVCache.layer`), so no step
copies the cache. Eager PyTorch needs neither the reference's layer scan nor
its decode window: the kernel skips the dead slot blocks itself.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig, PruneConfig
from repro_torch.core import cache as kvcache
from repro_torch.core.cache import KVCache, init_cache
from repro_torch.device import resolve_device
from repro_torch.models import layers as L
from repro_torch.models.attention_layer import (attention_decode,
                                                attention_prefill,
                                                attention_prefill_chunk)

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32,
          "float16": torch.float16}


@dataclass
class DecodeState:
    kv: KVCache                      # stacked [L, B, Hk, S, ·]


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


def lanes_insert(state: DecodeState, src, fresh: DecodeState) -> DecodeState:
    """In place: lane b of `state` takes row `src[b]` of the batch-G
    `fresh` state where `src[b] >= 0` (grouped admission)."""
    kvcache.lanes_insert(state.kv, src, fresh.kv, batch_axis=1)
    return state


def _store_layer(state: DecodeState, li: int, filled: KVCache) -> None:
    """Copy a filled one-layer cache into layer `li` of the stacked state."""
    for name, dst in vars(state.kv.layer(li)).items():
        if dst is not None:
            dst.copy_(getattr(filled, name))


def layer_params(params_seg: Dict[str, Any], li: int):
    """Layer `li`'s parameters out of a stacked segment (views)."""
    return {k: (layer_params(v, li) if isinstance(v, dict) else v[li])
            for k, v in params_seg.items()}


class Model:
    """Dense-family model facade (functional: params are passed in)."""

    def __init__(self, cfg: ModelConfig, prune: PruneConfig, device="cuda"):
        unsupported = [name for name, bad in (
            ("family", cfg.family != "dense"), ("norm", cfg.norm != "rms"),
            ("act", cfg.act != "swiglu"), ("pos", cfg.pos not in ("rope",
                                                              "none")),
            ("qkv_bias", cfg.qkv_bias), ("frontend", cfg.frontend != "none"),
            ("mtp_depth", cfg.mtp_depth > 0)) if bad]
        if unsupported:
            raise NotImplementedError(
                f"{cfg.name}: {', '.join(unsupported)} not ported yet "
                "(the port serves the dense family)")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.prune = prune

    @property
    def dtype(self) -> torch.dtype:
        return DTYPES[self.cfg.compute_dtype]

    # -- init ---------------------------------------------------------------

    def init(self, seed: int = 0) -> Dict[str, Any]:
        """Random weights from `seed`, made on the model's device, with the
        reference's distributions (N(0, 1/d_in) projections, N(0, 0.02²)
        embeddings, unit norms). The reference's JAX draws differ; use
        `params.from_reference` to run the same weights on both sides."""
        cfg = self.cfg
        dt = DTYPES[cfg.param_dtype]
        dev = self.device
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        n, d = cfg.num_layers, cfg.d_model

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def dense(d_in, d_out):
            return L.dense_init(gen, d_in, d_out, dt, dev, lead=(n,))

        params: Dict[str, Any] = {
            "embed": L.embed_init(gen, cfg.vocab_size, d, dt, dev),
            "final_norm": {"w": ones(d)},
            "seg0_dense": {
                "ln1": {"w": ones(n, d)}, "ln2": {"w": ones(n, d)},
                "attn": {"wq": dense(d, cfg.q_dim), "wk": dense(d, cfg.kv_dim),
                         "wv": dense(d, cfg.kv_dim), "wo": dense(cfg.q_dim, d)},
                "mlp": {"wi": dense(d, cfg.d_ff), "wg": dense(d, cfg.d_ff),
                        "wo": dense(cfg.d_ff, d)},
            },
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = L.dense_init(gen, d, cfg.vocab_size, dt, dev)
        return params

    # -- state --------------------------------------------------------------

    def init_decode_state(self, batch_size: int) -> DecodeState:
        cfg = self.cfg
        return DecodeState(kv=init_cache(
            batch_size, cfg.n_kv_heads, cfg.head_dim, self.prune.slots,
            self.prune, self.dtype, device=self.device,
            layers=cfg.num_layers))

    # -- shared pieces ------------------------------------------------------

    def _logits(self, params, x: torch.Tensor) -> torch.Tensor:
        x = L.apply_norm(params["final_norm"], x, self.cfg.norm)
        head = (params["embed"].T if self.cfg.tie_embeddings
                else params["lm_head"])
        return x.float() @ head.float()

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return params["embed"][tokens].to(self.dtype)

    # -- prefill --------------------------------------------------------------

    def prefill(self, params, batch) -> Tuple[torch.Tensor, DecodeState]:
        """Prompt pass with one-shot static pruning → (logits [B,V] at the
        last valid position, DecodeState).

        `batch["length"]` ([B] int32, optional) marks the true lengths of
        prompts right-padded to a shared bucket: pads neither attend,
        accumulate, nor enter the static top-k."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        length = batch.get("length")
        if length is not None:
            length = torch.as_tensor(length, dtype=torch.int32,
                                     device=self.device)
        b, t = tokens.shape
        x = self._embed(params, tokens)
        pos = torch.arange(t, device=self.device)[None]
        state = self.init_decode_state(b)
        seg = params["seg0_dense"]
        for li in range(cfg.num_layers):
            p = layer_params(seg, li)
            h = L.apply_norm(p["ln1"], x, cfg.norm)
            a, filled = attention_prefill(p["attn"], h, cfg, pos, self.prune,
                                          state.kv.layer(li), length=length)
            _store_layer(state, li, filled)
            x = x + a
            h = L.apply_norm(p["ln2"], x, cfg.norm)
            x = x + L.apply_mlp(p["mlp"], h, cfg.act)
        if length is None:
            x_last = x[:, -1]
        else:  # last *valid* position per lane, not the bucket's last pad
            x_last = x[torch.arange(b, device=self.device), length.long() - 1]
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

    def supports_chunked_prefill(self) -> bool:
        """Chunked prefill covers the plain attention stacks: every model
        the port builds (the dense family)."""
        return True

    def init_prefill_chunk_state(self, batch_size: int,
                                 bucket: int) -> PrefillChunkState:
        """Empty workspace for prompts padded to `bucket`."""
        cfg = self.cfg
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
        x = self._embed(params, tokens_c)
        pos = row0 + torch.arange(tokens_c.shape[1], device=self.device)[None]
        seg = params["seg0_dense"]
        for li in range(cfg.num_layers):
            p = layer_params(seg, li)
            h = L.apply_norm(p["ln1"], x, cfg.norm)
            a, _, _, _ = attention_prefill_chunk(
                p["attn"], h, cfg, pos, self.prune, pstate.k[li],
                pstate.v[li], pstate.acc[li], row0, length)
            x = x + a
            h = L.apply_norm(p["ln2"], x, cfg.norm)
            x = x + L.apply_mlp(p["mlp"], h, cfg.act)
        return x, pstate

    def prefill_finalize(self, params, pstate: PrefillChunkState, x_last,
                         row0: int, length) -> Tuple[torch.Tensor,
                                                     DecodeState]:
        """Finish a chunked prefill: the one-shot static pruning over the
        streamed buffers, and the logits at position length-1. x_last: the
        final chunk's hidden [B, C, d] (it holds that position); row0: its
        absolute offset. Returns (logits [B, V], DecodeState)."""
        length = torch.as_tensor(length, dtype=torch.int32,
                                 device=self.device)
        b = x_last.shape[0]
        state = self.init_decode_state(b)
        for li in range(self.cfg.num_layers):
            _store_layer(state, li, kvcache.prefill_fill(
                state.kv.layer(li), pstate.k[li], pstate.v[li],
                pstate.acc[li], self.prune, length=length))
        x_sel = x_last[torch.arange(b, device=self.device),
                       length.long() - 1 - int(row0)]
        return self._logits(params, x_sel), state

    # -- decode ---------------------------------------------------------------

    def decode_step(self, params, state: DecodeState, token: torch.Tensor,
                    active: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, DecodeState]:
        """token: [B] → (logits [B, V] f32, state updated in place).

        `active` ([B] bool, optional) freezes the other lanes' cache rows
        (finished lanes of a serving block)."""
        cfg = self.cfg
        token = torch.as_tensor(token, device=self.device)
        x = self._embed(params, token)
        seg = params["seg0_dense"]
        for li in range(cfg.num_layers):
            p = layer_params(seg, li)
            h = L.apply_norm(p["ln1"], x, cfg.norm)
            a = attention_decode(p["attn"], h, cfg, state.kv.layer(li),
                                 self.prune, active)
            x = x + a
            h = L.apply_norm(p["ln2"], x, cfg.norm)
            x = x + L.apply_mlp(p["mlp"], h, cfg.act)
        return self._logits(params, x), state
