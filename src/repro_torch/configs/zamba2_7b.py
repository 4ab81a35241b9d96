"""zamba2-7b [hybrid]: 81L d_model=3584 32H (kv=32) d_ff=14336 vocab=32000,
ssm_state=64 — Mamba2 backbone + SHARED attention block applied every
`attn_period` blocks (weights reused, Zamba2-style). [arXiv:2411.15242]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, register

CONFIG = register(ModelConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    n_heads=32,
    n_kv_heads=32,
    head_dim=112,
    d_ff=14336,
    vocab_size=32000,
    norm="rms",
    act="swiglu",
    pos="rope",
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, conv_kernel=4,
                  chunk_size=256),
    attn_period=6,
))
