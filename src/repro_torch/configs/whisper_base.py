"""whisper-base [audio]: 6L enc + 6L dec, d_model=512, 8H (kv=8), d_ff=2048,
vocab=51865. Encoder-decoder with conv frontend STUB (input_specs provides
precomputed mel-frame embeddings). [arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="whisper-base",
    family="encdec",
    num_layers=6,           # per-stack depth (enc_layers/dec_layers govern)
    enc_layers=6,
    dec_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    head_dim=64,
    d_ff=2048,
    vocab_size=51865,
    max_seq_len=32768,      # stress config per assignment (real model: 448)
    norm="ln",
    act="gelu",
    pos="sinusoidal",
    qkv_bias=True,
    frontend="audio",
    frontend_len=1500,      # encoder positions (precomputed frame embeddings)
))
