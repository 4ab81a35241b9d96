"""llava-next-mistral-7b [vlm]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000 — mistral backbone; anyres vision tiling is a STUB
(input_specs provides precomputed patch embeddings).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llava-next-mistral-7b",
    family="dense",
    num_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32000,
    norm="rms",
    act="swiglu",
    pos="rope",
    frontend="vision",
    frontend_len=576,       # one 24x24 patch grid (anyres tiles stubbed)
))
