"""Plain PyTorch versions of the CUDA kernels, in the model layout.

Deliberately naive — a full mask and one softmax for attention, a loop over
time for the two scans — so they are easy to audit. The wrappers in ``ops.py`` run them for tensors on the CPU, the tests
hold them against ``repro.kernels.ref`` and the Pallas kernels in
interpret mode, and the chip smoke run holds each CUDA kernel
against them on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def flash_attention(
    q: torch.Tensor,              # (B, Sq, H, D)
    k: torch.Tensor,              # (B, Sk, KVH, D)
    v: torch.Tensor,              # (B, Sk, KVH, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Causal / sliding-window (``q_pos - k_pos < window``) / non-causal
    attention; kv head ``h // G`` serves query head ``h``."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    G = H // KVH
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qr = (q * scale).reshape(B, Sq, KVH, G, D).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float())
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    k_pos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones(Sq, Sk, dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= k_pos
    if window is not None:
        mask &= q_pos - k_pos < window
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, D)
    k_cache: torch.Tensor,        # (B, S, KVH, D)
    v_cache: torch.Tensor,        # (B, S, KVH, D)
    lengths: torch.Tensor,        # (B,) valid cache entries, incl. the new one
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """One query per sequence against the cache; positions ``>= length``
    (and ``< length - window``) are masked."""
    B, _, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    G = H // KVH
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    qh = (q * scale).reshape(B, KVH, G, D).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qh, k_cache.float())
    pos = torch.arange(S, device=q.device)[None]
    lengths = lengths.to(q.device)[:, None]
    mask = pos < lengths
    if window is not None:
        mask &= pos >= lengths - window
    s = s.masked_fill(~mask[:, None, None], NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p, v_cache.float())
    return out.reshape(B, 1, H, v_cache.shape[-1]).to(q.dtype)


def rglru(a: torch.Tensor, b: torch.Tensor, h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Sequential recurrence ``h_t = a_t·h_{t-1} + b_t`` over a, b (B, S, W),
    carried in float32; h (B, S, W) in b's dtype."""
    B, S, W = a.shape
    h = torch.zeros(B, W, dtype=torch.float32, device=a.device) if h0 is None else h0.float()
    out = torch.empty(B, S, W, dtype=b.dtype, device=b.device)
    for t in range(S):
        h = a[:, t].float() * h + b[:, t].float()
        out[:, t] = h.to(b.dtype)
    return out


def ssd(
    x: torch.Tensor,              # (B, S, H, P) dt-scaled inputs
    a: torch.Tensor,              # (B, S, H) log decays
    Bm: torch.Tensor,             # (B, S, H, N)
    Cm: torch.Tensor,             # (B, S, H, N)
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-by-token SSD recurrence ``h = exp(a)·h + x⊗B``, ``y = h·C``.
    Returns (y (B, S, H, P) in x's dtype, final state (B, H, P, N) f32)."""
    B, S, H, P = x.shape
    N = Bm.shape[-1]
    h = (torch.zeros(B, H, P, N, dtype=torch.float32, device=x.device) if h0 is None
         else h0.float())
    y = torch.empty(B, S, H, P, dtype=x.dtype, device=x.device)
    for t in range(S):
        decay = torch.exp(a[:, t].float())[..., None, None]
        h = decay * h + torch.einsum("bhp,bhn->bhpn", x[:, t].float(), Bm[:, t].float())
        y[:, t] = torch.einsum("bhpn,bhn->bhp", h, Cm[:, t].float()).to(x.dtype)
    return y, h
