"""grok-1-314b [moe]: 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072, MoE 8e top-2. [hf:xai-org/grok-1]"""
from repro_torch.configs.base import MoEConfig, ModelConfig, register

CONFIG = register(ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    norm="rms",
    act="swiglu",    # gated expert FFN (3 matrices) — matches the 314B count
    pos="rope",
    moe=MoEConfig(
        n_experts=8,
        top_k=2,
        n_shared=0,
        d_ff_expert=32768,
    ),
))
