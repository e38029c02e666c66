"""Decoder-only LM stack, the port of ``repro.models.transformer`` for the
dense family (MoE and VLM are later items of ROADMAP Queue A). A Python
loop over layers replaces ``scan``; the per-layer parameters are views into
the stacked ``(L, ...)`` leaves, so the tree keeps the reference's paths.

Shapes legend: B batch, S sequence, d d_model, H heads, KVH kv heads,
hd head dim, V (padded) vocab, L layers.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from ..configs import ModelConfig
from . import attention as attn
from .common import embed_tokens, lm_logits, rms_norm, swiglu
from .knobs import DEFAULT_KNOBS, RunKnobs
from .params import ParamSpec, map_tree, stack


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

def ffn_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn"), "scaled_normal"),
        "w_up": ParamSpec((d, f), ("embed", "ffn"), "scaled_normal"),
        "w_down": ParamSpec((f, d), ("ffn", "embed"), "scaled_normal"),
    }


def block_spec(cfg: ModelConfig) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
        "attn": attn.attn_spec(cfg),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
        "ffn": ffn_spec(cfg),
    }


def model_spec(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab()
    spec = {
        "embed": {"tok": ParamSpec((v, cfg.d_model), ("vocab", "embed"), "normal", 0.02)},
        "blocks": stack(block_spec(cfg), cfg.n_layers),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
    }
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((cfg.d_model, v), ("embed", "vocab"), "scaled_normal")
    return spec


def _head(cfg: ModelConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tok"].T
    return params["lm_head"]


def _layer(params: dict, i: int) -> dict:
    return map_tree(lambda t: t[i], params["blocks"])


def build_positions(B: int, S: int, device: torch.device) -> torch.Tensor:
    """(B, S) standard positions (the VLM's M-RoPE grid is not ported)."""
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(B, S)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

def _ffn(lp: dict, h: torch.Tensor) -> torch.Tensor:
    f = lp["ffn"]
    return swiglu(h, f["w_gate"], f["w_up"], f["w_down"])


def forward_hidden(
    cfg: ModelConfig,
    params: dict,
    x: torch.Tensor,              # (B, S, d) embedded inputs
    positions: torch.Tensor,
    knobs: RunKnobs,
    *,
    collect_kv: bool = False,
) -> Tuple[torch.Tensor, Optional[List[Tuple[torch.Tensor, torch.Tensor]]]]:
    """Run the block stack. Returns (hidden, kv per layer or None)."""
    kvs = [] if collect_kv else None
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        if collect_kv:
            a, kv = attn.attn_full(cfg, lp["attn"], h, positions, knobs, return_kv=True)
            kvs.append(kv)
        else:
            a = attn.attn_full(cfg, lp["attn"], h, positions, knobs)
        x = x + a
        x = x + _ffn(lp, rms_norm(x, lp["ln2"], cfg.norm_eps))
    return rms_norm(x, params["ln_f"], cfg.norm_eps), kvs


# ---------------------------------------------------------------------------
# Serving: prefill + decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device) -> dict:
    per_layer = [attn.attn_cache_init(cfg, batch, max_seq, dtype, device)
                 for _ in range(cfg.n_layers)]
    return {"layers": per_layer, "pos": 0,
            "lengths": torch.zeros(batch, dtype=torch.int32, device=device)}


def prefill(
    cfg: ModelConfig,
    params: dict,
    batch: Dict[str, torch.Tensor],
    knobs: RunKnobs = DEFAULT_KNOBS,
    cache_len: Optional[int] = None,
) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward; returns (last-position logits, populated cache).

    The logits are read at the last position (``transformer.py:231`` of the
    reference), whatever the prompt holds there."""
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"]["tok"], tokens, getattr(torch, cfg.dtype))
    B, S = tokens.shape
    positions = build_positions(B, S, tokens.device)
    hidden, kvs = forward_hidden(cfg, params, x, positions, knobs, collect_kv=True)
    logits = lm_logits(hidden[:, -1:], _head(cfg, params), cfg.vocab_size)
    max_seq = cache_len or S
    cache = {"layers": [attn.attn_cache_from_prefill(cfg, kv, max_seq) for kv in kvs],
             "pos": S,
             "lengths": torch.full((B,), S, dtype=torch.int32, device=tokens.device)}
    return logits[:, 0], cache


def decode_step(
    cfg: ModelConfig,
    params: dict,
    cache: dict,
    batch: Dict[str, torch.Tensor],
    knobs: RunKnobs = DEFAULT_KNOBS,
) -> Tuple[torch.Tensor, dict]:
    """One token for every sequence. batch = {"tokens": (B, 1)}. The layer
    caches are updated in place; the returned dict carries the new position
    and lengths."""
    x = embed_tokens(params["embed"]["tok"], batch["tokens"], getattr(torch, cfg.dtype))
    pos, lengths = cache["pos"], cache["lengths"] + 1
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        a, _ = attn.attn_decode(cfg, lp["attn"], h, cache["layers"][i], pos, lengths, knobs)
        x = x + a
        x = x + _ffn(lp, rms_norm(x, lp["ln2"], cfg.norm_eps))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = lm_logits(x, _head(cfg, params), cfg.vocab_size)
    new_cache = {"layers": cache["layers"], "pos": pos + 1, "lengths": lengths}
    return logits[:, 0], new_cache
