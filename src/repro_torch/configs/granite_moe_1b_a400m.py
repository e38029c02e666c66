"""granite-moe-1b-a400m — 24L d1024 16H (GQA kv=8) d_ff=512/expert, 32e top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from .base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    family="moe",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,                      # per-expert FFN hidden size
    vocab_size=49_155,
    rope_theta=10_000.0,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="granite-moe-1b-a400m@smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=32,
        vocab_size=128,
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32,
                      capacity_factor=8.0),
    )
