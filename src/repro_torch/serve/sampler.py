"""Token sampling for the serving path."""
from __future__ import annotations

from typing import Optional

import torch


def sample(logits: torch.Tensor, gen: Optional[torch.Generator] = None,
           temperature: float = 0.0, top_k: int = 0) -> torch.Tensor:
    """logits: (B, V) → (B,) int32 tokens. temperature 0 == greedy, exactly
    as the reference. Above 0 the draw comes from ``gen`` (a generator on the
    logits' device); it cannot match ``jax.random`` draw for draw."""
    if temperature <= 0.0:
        return logits.argmax(dim=-1).to(torch.int32)
    logits = logits.float() / temperature
    if top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = logits.masked_fill(logits < kth, -1e30)
    probs = torch.softmax(logits, dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)
