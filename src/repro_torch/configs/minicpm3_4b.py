"""minicpm3-4b — dense w/ multi-head latent attention (MLA), 62L d2560 40H
d_ff=6400. [hf:openbmb/MiniCPM3-4B; hf]"""
from .base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2560,
    n_heads=40,
    n_kv_heads=40,                 # MLA: latent cache, head count == n_heads
    d_ff=6400,
    vocab_size=73_448,
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b@smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        mla=MLAConfig(
            q_lora_rank=32,
            kv_lora_rank=16,
            qk_nope_head_dim=8,
            qk_rope_head_dim=4,
            v_head_dim=8,
        ),
    )
