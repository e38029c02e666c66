"""Attention sub-blocks, the port of ``repro.models.attention``: the standard
GQA half (optionally windowed), with a full-sequence path (prefill) and a
KV-cache decode path. MLA is not ported yet (ROADMAP Queue A item 9).

``knobs.use_kernels`` (the port's default) sends both paths through the
CUDA kernels of ``kernels/ops.py``: ``attn_full`` calls
``ops.flash_attention``, and ``attn_decode`` calls ``ops.decode_attention``
where the reference calls the einsum of ``models/common.py``
(``repro/models/attention.py:200``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..configs import ModelConfig
from ..kernels import ops
from .common import apply_rope, chunked_attention, decode_attention
from .knobs import RunKnobs
from .params import ParamSpec


def attn_spec(cfg: ModelConfig) -> dict:
    if cfg.mla is not None:
        raise NotImplementedError("MLA attention is not ported yet (ROADMAP Queue A item 9)")
    d, H, KVH, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    spec = {
        "wq": ParamSpec((d, H * hd), ("embed", "heads_dim"), "scaled_normal"),
        "wk": ParamSpec((d, KVH * hd), ("embed", "heads_dim"), "scaled_normal"),
        "wv": ParamSpec((d, KVH * hd), ("embed", "heads_dim"), "scaled_normal"),
        "wo": ParamSpec((H * hd, d), ("heads_dim", "embed"), "scaled_normal"),
    }
    if cfg.qkv_bias:
        spec["bq"] = ParamSpec((H * hd,), ("heads_dim",), "zeros")
        spec["bk"] = ParamSpec((KVH * hd,), ("heads_dim",), "zeros")
        spec["bv"] = ParamSpec((KVH * hd,), ("heads_dim",), "zeros")
    return spec


def _qkv(cfg: ModelConfig, p: dict, h: torch.Tensor):
    B, S, _ = h.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KVH, hd),
            v.reshape(B, S, KVH, hd))


def _window(cfg: ModelConfig, window: Optional[int]) -> Optional[int]:
    if window is not None:
        return window
    if cfg.attention_kind == "local" and cfg.recurrent:
        return cfg.recurrent.attention_window
    return None


def attn_full(
    cfg: ModelConfig,
    p: dict,
    h: torch.Tensor,              # (B, S, d) — already normed
    positions: torch.Tensor,      # (B, S)
    knobs: RunKnobs,
    *,
    window: Optional[int] = None,
    causal: bool = True,
    return_kv: bool = False,
):
    q, k, v = _qkv(cfg, p, h)
    q, k = apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
    w = _window(cfg, window)
    if knobs.use_kernels:
        out = ops.flash_attention(q, k, v, causal=causal, window=w)
    else:
        out = chunked_attention(q, k, v, causal=causal, window=w,
                                q_block=knobs.q_block, kv_block=knobs.kv_block)
    B, S = h.shape[:2]
    y = out.reshape(B, S, -1) @ p["wo"]
    if return_kv:
        return y, (k, v)
    return y


def attn_cache_init(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
                    device: torch.device) -> dict:
    KVH, hd = cfg.n_kv_heads, cfg.head_dim_
    return {
        "k": torch.zeros((batch, max_seq, KVH, hd), dtype=dtype, device=device),
        "v": torch.zeros((batch, max_seq, KVH, hd), dtype=dtype, device=device),
    }


def attn_cache_from_prefill(cfg: ModelConfig, kv, max_seq: int) -> dict:
    """Pad prefill-computed K/V out to the cache buffer."""
    k, v = kv
    B, S = k.shape[:2]
    cache = attn_cache_init(cfg, B, max_seq, k.dtype, k.device)
    cache["k"][:, :S] = k
    cache["v"][:, :S] = v
    return cache


def attn_decode(
    cfg: ModelConfig,
    p: dict,
    h: torch.Tensor,              # (B, 1, d) — already normed
    cache: dict,                  # per-layer cache, updated in place
    pos: int,                     # write index
    lengths: torch.Tensor,        # (B,) int32 valid lengths incl. this token
    knobs: RunKnobs,
    *,
    window: Optional[int] = None,
) -> Tuple[torch.Tensor, dict]:
    """One token. Unlike the reference, which returns new cache arrays, the
    new K/V are written into ``cache`` in place: the port keeps one buffer
    per layer for the whole generation."""
    B = h.shape[0]
    if pos >= cache["k"].shape[1]:
        raise ValueError(f"decode position {pos} is past the cache "
                         f"({cache['k'].shape[1]} slots)")
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    q, k, v = _qkv(cfg, p, h)
    q, k = apply_rope(q, positions, cfg.rope_theta), apply_rope(k, positions, cfg.rope_theta)
    k_cache, v_cache = cache["k"], cache["v"]
    k_cache[:, pos] = k[:, 0].to(k_cache.dtype)
    v_cache[:, pos] = v[:, 0].to(v_cache.dtype)
    attend = ops.decode_attention if knobs.use_kernels else decode_attention
    out = attend(q, k_cache, v_cache, lengths, window=_window(cfg, window))
    y = out.reshape(B, 1, -1) @ p["wo"]
    return y, cache
