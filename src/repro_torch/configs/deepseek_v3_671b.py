"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff=2048(expert)
vocab=129280, MoE 256e top-8, 1 shared expert, MLA latent attention,
first 3 layers dense FFN (d_ff 18432), optional MTP head. [arXiv:2412.19437]"""
from repro_torch.configs.base import (MLAConfig, MoEConfig, ModelConfig,
                                     register)

CONFIG = register(ModelConfig(
    name="deepseek-v3-671b",
    family="mla_moe",
    num_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    head_dim=128,           # qk_nope/v head dim (MLA governs actual dims)
    d_ff=18432,             # dense layers' hidden
    vocab_size=129280,
    norm="rms",
    act="swiglu",
    pos="rope",
    moe=MoEConfig(
        n_experts=256,
        top_k=8,
        n_shared=1,
        d_ff_expert=2048,
        dense_first_k=3,
        d_ff_dense=18432,
    ),
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_dim=128,
    ),
    mtp_depth=1,
))
