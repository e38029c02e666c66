"""mamba2-370m — attention-free SSM (SSD / state-space duality), 48L d1024,
ssm_state=128. Sub-quadratic. [arXiv:2405.21060; unverified]"""
from .base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,                     # attention-free
    n_kv_heads=0,
    d_ff=0,                        # no separate FFN; Mamba block is the mixer
    vocab_size=50_280,
    subquadratic=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, chunk_size=256),
)


def reduced() -> ModelConfig:
    return ModelConfig(
        name="mamba2-370m@smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab_size=128,
        subquadratic=True,
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16, chunk_size=16),
    )
