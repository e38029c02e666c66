"""phi4-mini-3.8b — dense, 32L d3072 24H (GQA kv=8) d_ff=8192, RoPE SwiGLU GQA.
[arXiv:2412.08905; hf]"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi4-mini-3.8b",
    family="dense",
    n_layers=32,
    d_model=3072,
    n_heads=24,
    n_kv_heads=8,
    d_ff=8192,
    vocab_size=200_064,
    rope_theta=10_000.0,
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="phi4-mini-3.8b@smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        tie_embeddings=True,
    )
