"""qwen2-vl-7b — VLM backbone, 28L d3584 28H (GQA kv=4) d_ff=18944, M-RoPE.
Vision frontend is a STUB (precomputed patch embeddings). [arXiv:2409.12191; hf]"""
from .base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="qwen2-vl-7b",
    family="vlm",
    n_layers=28,
    d_model=3584,
    n_heads=28,
    n_kv_heads=4,
    d_ff=18_944,
    vocab_size=152_064,
    qkv_bias=True,
    rope_theta=1_000_000.0,
    vlm=VLMConfig(vision_prefix_len=1024, mrope_sections=(16, 24, 24)),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b@smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab_size=128,
        qkv_bias=True,
        vlm=VLMConfig(vision_prefix_len=8, mrope_sections=(2, 3, 3)),
    )
