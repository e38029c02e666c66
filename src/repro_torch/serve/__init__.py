from .fabric import (
    TORCH_PREFIX,
    install,
    pad_to_bucket,
    parse_torch_key,
    serve_decode,
    serve_generate,
    serve_prefill,
    shape_bucket,
    torch_key,
)
from .sampler import sample
from .serve_step import generate, make_decode, make_prefill

__all__ = [
    "TORCH_PREFIX", "generate", "install", "make_decode", "make_prefill",
    "pad_to_bucket", "parse_torch_key", "sample", "serve_decode",
    "serve_generate", "serve_prefill", "shape_bucket", "torch_key",
]
