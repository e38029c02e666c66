"""Serving substrate, the port of ``repro.serve.serve_step``: prefill and
decode step builders and a host generation loop. PyTorch runs eagerly, so
the builders return plain closures where the reference hands them to
``jax.jit``."""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch

from ..models import Model
from ..models.knobs import DEFAULT_KNOBS, RunKnobs
from .sampler import sample


def make_prefill(model: Model, knobs: RunKnobs = DEFAULT_KNOBS,
                 cache_len: Optional[int] = None) -> Callable:
    def prefill_step(params, batch):
        return model.prefill(params, batch, knobs, cache_len=cache_len)
    return prefill_step


def make_decode(model: Model, knobs: RunKnobs = DEFAULT_KNOBS) -> Callable:
    def decode_step(params, cache, batch):
        return model.decode_step(params, cache, batch, knobs)
    return decode_step


def generate(
    model: Model,
    params: Any,
    batch: Dict[str, torch.Tensor],
    n_tokens: int,
    *,
    gen: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: int = 0,
    knobs: RunKnobs = DEFAULT_KNOBS,
) -> torch.Tensor:
    """Host loop: prefill then ``n_tokens - 1`` decode steps. Returns
    (B, n_tokens) int32 on the device of the prompt."""
    S = batch["tokens"].shape[1]
    prefill = make_prefill(model, knobs, cache_len=S + n_tokens)
    decode = make_decode(model, knobs)
    logits, cache = prefill(params, batch)
    tok = sample(logits, gen, temperature, top_k)
    toks = [tok]
    for _ in range(n_tokens - 1):
        logits, cache = decode(params, cache, {"tokens": tok[:, None]})
        tok = sample(logits, gen, temperature, top_k)
        toks.append(tok)
    return torch.stack(toks, dim=1)
