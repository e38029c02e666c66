"""llama4-scout-17b-a16e — 48L d5120 40H (GQA kv=8) d_ff=8192, 16e top-1.
[hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from .base import MoEConfig, ModelConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=202_048,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="llama4-scout-17b-a16e@smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=64,
        vocab_size=128,
        # generous capacity at smoke scale: keeps prefill/decode exactly
        # consistent (no token drops with an untrained, skewed router)
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=64,
                      capacity_factor=8.0),
    )
