"""recurrentgemma-9b — hybrid RG-LRU + local attention (2 recurrent : 1 attn),
38L d4096 16H (MQA kv=1) d_ff=12288. Sub-quadratic. [arXiv:2402.19427; unverified]"""
from .base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                   # must be handled by pattern cycling (38 = 12*3 + 2)
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12_288,
    vocab_size=256_000,
    attention_kind="local",
    subquadratic=True,
    tie_embeddings=True,
    recurrent=RecurrentConfig(lru_width=4096, attention_window=2048),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-9b@smoke",
        family="hybrid",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_ff=128,
        vocab_size=128,
        attention_kind="local",
        subquadratic=True,
        recurrent=RecurrentConfig(lru_width=64, attention_window=16),
    )
