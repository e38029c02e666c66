"""The assigned input-shape sets (same four for every LM-family arch)."""
from __future__ import annotations

from .base import ShapeConfig

SHAPES = {
    "train_4k": ShapeConfig("train_4k", seq_len=4_096, global_batch=256, kind="train"),
    "prefill_32k": ShapeConfig("prefill_32k", seq_len=32_768, global_batch=32, kind="prefill"),
    "decode_32k": ShapeConfig("decode_32k", seq_len=32_768, global_batch=128, kind="decode"),
    "long_500k": ShapeConfig("long_500k", seq_len=524_288, global_batch=1, kind="decode"),
}

# Reduced shapes used by smoke tests (same kinds, tiny sizes).
SMOKE_SHAPES = {
    "train_4k": ShapeConfig("smoke_train", seq_len=32, global_batch=2, kind="train"),
    "prefill_32k": ShapeConfig("smoke_prefill", seq_len=64, global_batch=2, kind="prefill"),
    "decode_32k": ShapeConfig("smoke_decode", seq_len=64, global_batch=2, kind="decode"),
    "long_500k": ShapeConfig("smoke_long", seq_len=128, global_batch=1, kind="decode"),
}


def get_shape(name: str) -> ShapeConfig:
    try:
        return SHAPES[name]
    except KeyError:
        raise KeyError(f"unknown shape {name!r}; options: {sorted(SHAPES)}") from None
