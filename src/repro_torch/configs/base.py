"""Configuration for the PyTorch port: a copy of the reference package's
`configs/base.py`, so the port imports nothing of that package.

  * ModelConfig  — architecture hyper-parameters
  * PruneConfig  — the paper's static-dynamic KV-cache pruning knobs
  * ShapeConfig  — the assigned (seq_len, global_batch, kind) input shapes

Configs are frozen dataclasses, as in the reference. The registry loads
the configurations this port serves: the dense family (longchat-7b,
granite-3-2b, phi3-medium-14b, starcoder2-3b, minitron-8b and the
vision-frontend llava-next-mistral-7b), the MoE family (grok-1-314b),
the mla_moe family (deepseek-v3-671b), the SSM family (mamba2-1.3b), the
hybrid (zamba2-7b) and the encoder-decoder (whisper-base).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Pruning (the paper's technique)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PruneConfig:
    """UniCAIM static-dynamic KV cache pruning configuration.

    policy:
      'unicaim'   — paper technique: quantized approx scoring (CAM mode),
                    top-k dynamic selection, accumulated-score static eviction
      'h2o'       — exact-score accumulation + static eviction, no dynamic top-k
      'streaming' — StreamingLLM: sinks + sliding window (position eviction)
      'dense'     — no pruning (baseline)
    """

    policy: str = "unicaim"
    # --- static budget: S = heavy_budget + reserve slots (paper: 512 + 64) ---
    heavy_budget: int = 512
    reserve: int = 64
    # --- protected tokens (never evicted, always selected) ---
    sink_tokens: int = 4
    recent_window: int = 32
    # --- CAM mode: approximate scoring precision (paper: 1..3 bit cells) ---
    score_bits: int = 3          # key mirror bits (1..8); 8 == int8
    query_bits: int = 4          # query "bitwise expansion" bits
    # --- dynamic selection ---
    select_k: int = 64           # top-k tokens entering exact attention
    select_mode: str = "topk"    # 'topk' (exact top-k) | 'threshold' (CAM race)
    threshold_iters: int = 8     # binary-search iterations for the CAM race
    # >1: hierarchical selection — top-(k/nb) within each of nb slot blocks.
    # With slots sharded over `model`, blocks align with shards, so select +
    # gather + exact attention stay SHARD-LOCAL (the distributed analog of
    # the paper's per-array CAM race). §Perf optimization for decode cells.
    select_blocks: int = 1
    # --- cache storage precision (paper: the SAME multilevel FeFET cells
    #     store the cache — low-bit storage is the faithful reading).
    #     'int8': K/V stored int8 + per-(token,head) scales; the int8 K IS
    #     the scoring mirror (no separate copy). Halves cache bytes AND the
    #     CAM-pass reads. §Perf/memory knob for long-context decode. ---
    kv_dtype: str = "bf16"       # 'bf16' | 'int8' (unicaim policy only)
    # --- fused single-pass decode engine: scoring, selection, winner
    #     gather and exact attention in one kernel (the Hopper
    #     `ragged_decode` kernel on a CUDA tensor, its plain PyTorch
    #     version on a CPU tensor) instead of the composed three-pass
    #     flow, which stays as the oracle. fused="auto" runs the kernel
    #     on an sm_90 card and the composed path elsewhere. ---
    fused: object = False        # False | True | "auto"
    # --- charge-domain accumulation ---
    accumulate: str = "approx"   # 'approx' (same-cycle, paper) | 'exact'
    acc_decay: float = 1.0       # optional exponential decay of history
    init_new_score: str = "mean"  # 'mean' | 'zero' — acc init for new tokens
    # --- prefill scoring: 0 = accumulate over all queries (H2O-style);
    #     >0 = only the last W queries (SnapKV-style observation window) ---
    prefill_obs_window: int = 0

    @property
    def slots(self) -> int:
        return self.heavy_budget + self.reserve

    def validate(self) -> None:
        assert self.policy in ("unicaim", "h2o", "streaming", "dense")
        assert 1 <= self.score_bits <= 8
        assert 1 <= self.query_bits <= 8
        assert self.select_mode in ("topk", "threshold")
        assert self.fused in (True, False, "auto")
        assert self.accumulate in ("approx", "exact")
        assert self.select_k <= self.slots
        assert self.sink_tokens + self.recent_window < self.slots


# ---------------------------------------------------------------------------
# Model architectures
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0            # shared (always-on) experts
    d_ff_expert: int = 2048      # per-expert hidden dim
    dense_first_k: int = 0       # first K layers use dense FFN (deepseek-v3)
    d_ff_dense: int = 0          # hidden dim of those dense layers
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    aux_loss_weight: float = 0.001


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_dim: int = 128

    @property
    def latent_dim(self) -> int:       # cached per-token latent width
        return self.kv_lora_rank + self.qk_rope_dim


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 (SSD) block configuration."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_kernel: int = 4
    chunk_size: int = 256
    n_groups: int = 1            # B/C projection groups


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | mla_moe | ssm | hybrid | encdec
    num_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    head_dim: int = 64
    d_ff: int = 1024
    vocab_size: int = 32000
    max_seq_len: int = 32768
    # layer flavour
    norm: str = "rms"            # rms | ln
    act: str = "swiglu"          # swiglu | gelu | relu2
    pos: str = "rope"            # rope | sinusoidal | none
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    qkv_bias: bool = False
    # families
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): shared attention block every `attn_period` ssm blocks
    attn_period: int = 0
    # encoder-decoder (whisper)
    enc_layers: int = 0
    dec_layers: int = 0
    # multimodal frontend stub: 'none' | 'audio' | 'vision'
    frontend: str = "none"
    frontend_len: int = 0        # number of frontend embedding positions
    # multi-token prediction depth (deepseek-v3 MTP); 0 = off
    mtp_depth: int = 0
    # chunk length for the XLA chunked-attention scan (train/prefill);
    # larger chunks re-read full K/V fewer times (§Perf memory knob)
    attn_chunk: int = 512
    # expert-parallel MoE dispatch via shard_map all_to_all instead of the
    # XLA-propagated sort-based dispatch (§Perf collective knob)
    moe_ep: bool = False
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def has_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (total; MoE counts all experts)."""
        d, L = self.d_model, self.num_layers
        emb = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            s = self.ssm
            d_in = s.expand * d
            n_heads = d_in // s.head_dim
            per = (d * (2 * d_in + 2 * s.n_groups * s.d_state + n_heads)  # in_proj
                   + s.conv_kernel * (d_in + 2 * s.n_groups * s.d_state)
                   + d_in * d + 2 * n_heads + d)                          # out_proj+A,D+norm
            return emb + L * per
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.mla is not None:
            m = self.mla
            attn = (d * m.q_lora_rank
                    + m.q_lora_rank * self.n_heads * (m.qk_nope_dim + m.qk_rope_dim)
                    + d * (m.kv_lora_rank + m.qk_rope_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_dim)
                    + self.n_heads * m.v_dim * d)
        ff_mult = 3 if self.act == "swiglu" else 2
        if self.moe is not None:
            mo = self.moe
            moe_layers = L - mo.dense_first_k
            per_expert = ff_mult * d * mo.d_ff_expert
            ff = (moe_layers * (mo.n_experts + mo.n_shared) * per_expert
                  + moe_layers * d * mo.n_experts                     # router
                  + mo.dense_first_k * ff_mult * d * mo.d_ff_dense)
            return emb + L * (attn + 2 * d) + ff
        ff = L * ff_mult * d * self.d_ff
        if self.family == "hybrid":
            s = self.ssm
            d_in = s.expand * d
            n_ssm_heads = d_in // s.head_dim
            ssm_per = (d * (2 * d_in + 2 * s.n_groups * s.d_state + n_ssm_heads)
                       + s.conv_kernel * (d_in + 2 * s.n_groups * s.d_state)
                       + d_in * d + 2 * n_ssm_heads + d)
            shared = attn + ff_mult * d * self.d_ff + 2 * d
            return emb + L * ssm_per + shared
        if self.family == "encdec":
            # enc: self-attn + ff; dec: self + cross + ff
            per_enc = attn + ff_mult * d * self.d_ff + 2 * d
            per_dec = 2 * attn + ff_mult * d * self.d_ff + 3 * d
            return emb + self.enc_layers * per_enc + self.dec_layers * per_dec
        return emb + L * (attn + 2 * d) + ff

    def active_param_count(self) -> int:
        """Per-token active parameters (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        d, L = self.d_model, self.num_layers
        ff_mult = 3 if self.act == "swiglu" else 2
        total = self.param_count()
        moe_layers = L - mo.dense_first_k
        per_expert = ff_mult * d * mo.d_ff_expert
        all_experts = moe_layers * mo.n_experts * per_expert
        active_experts = moe_layers * mo.top_k * per_expert
        return total - all_experts + active_experts


# ---------------------------------------------------------------------------
# Assigned input shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                    # 'train' | 'prefill' | 'decode'
    seq_len: int
    global_batch: int

    def validate(self) -> None:
        assert self.kind in ("train", "prefill", "decode")


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", "train", 4096, 256),
    ShapeConfig("prefill_32k", "prefill", 32768, 32),
    ShapeConfig("decode_32k", "decode", 32768, 128),
    ShapeConfig("long_500k", "decode", 524288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------

_REGISTRY = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    _ensure_loaded()
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch '{name}'; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs():
    _ensure_loaded()
    return sorted(_REGISTRY)


def _ensure_loaded():
    # import all config modules once so they register themselves
    if _REGISTRY.get("__loaded__"):
        return
    from repro_torch.configs import (  # noqa: F401
        deepseek_v3_671b, granite_3_2b, grok1_314b, llava_next_mistral_7b,
        longchat_7b, mamba2_1p3b, minitron_8b, phi3_medium_14b,
        starcoder2_3b, whisper_base, zamba2_7b)
    _REGISTRY["__loaded__"] = True


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Build a tiny same-family config for CPU smoke tests."""
    small = dict(
        num_layers=2, d_model=64, n_heads=4, n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16, d_ff=128, vocab_size=256, max_seq_len=512,
        param_dtype="float32", compute_dtype="float32",
    )
    if cfg.moe is not None:
        small["moe"] = dataclasses.replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=64,
            dense_first_k=min(cfg.moe.dense_first_k, 1), d_ff_dense=128)
    if cfg.mla is not None:
        small["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=32,
                                 qk_nope_dim=16, qk_rope_dim=8, v_dim=16)
        small["head_dim"] = 16
    if cfg.ssm is not None:
        small["ssm"] = dataclasses.replace(cfg.ssm, d_state=16, head_dim=16,
                                           chunk_size=32)
    if cfg.family == "hybrid":
        small["num_layers"] = 4
        small["attn_period"] = 2
    if cfg.family == "encdec":
        small["enc_layers"] = 2
        small["dec_layers"] = 2
    if cfg.frontend != "none":
        small["frontend_len"] = 8
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
