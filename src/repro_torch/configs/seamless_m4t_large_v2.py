"""seamless-m4t-large-v2 — enc-dec, 24L d1024 16H (GQA kv=16) d_ff=8192,
vocab 256206. Audio frontend is a STUB (precomputed frame embeddings).
[arXiv:2308.11596; hf]"""
from .base import EncDecConfig, ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                   # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    encdec=EncDecConfig(n_encoder_layers=24),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="seamless-m4t-large-v2@smoke",
        family="audio",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab_size=128,
        encdec=EncDecConfig(n_encoder_layers=2),
    )
