"""longchat-v1.5-7b-32k — the paper's own evaluation model (llama-2-7b
derivative with 32k context): 32L d_model=4096 32H MHA d_ff=11008
vocab=32000. Used for application-level benchmarks (paper Fig. 13)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="longchat-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    head_dim=128,
    d_ff=11008,
    vocab_size=32000,
    norm="rms",
    act="swiglu",
    pos="rope",
))
