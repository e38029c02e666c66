"""Shared model components, the port of ``repro.models.common``: norms,
RoPE, GQA attention (plain chunked implementation), SwiGLU, embeddings and
the LM head.

``chunked_attention`` and ``decode_attention`` here are the plain path that
``RunKnobs(use_kernels=False)`` selects; the kernels of ``kernels/ops.py``
implement the same contracts. Precision follows the reference: statistics
and RoPE in float32, attention scores and softmax in float32, results cast
back to the activation dtype.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# Single-token attention against the KV cache: the plain version of the
# decode kernel serves as the model's plain path too, as the reference's
# decode kernel is held against ``repro.models.common.decode_attention``.
from ..kernels.ref import decode_attention

__all__ = ["NEG_INF", "apply_rope", "chunked_attention", "decode_attention", "embed_tokens",
           "lm_logits", "rms_norm", "rope_freqs", "swiglu"]

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (split-half form)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    # a Python-float base: a tensor made from ``theta`` would be a host-to-device
    # copy, which waits for the stream on every call
    return 1.0 / torch.pow(theta, exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) int."""
    d = x.shape[-1]
    inv = rope_freqs(d, theta, x.device)                         # (D/2,)
    ang = positions[..., None].float() * inv                     # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention — plain chunked (flash-style) implementation
# ---------------------------------------------------------------------------

def chunked_attention(
    q: torch.Tensor,              # (B, Sq, H, D)
    k: torch.Tensor,              # (B, Sk, KVH, D)
    v: torch.Tensor,              # (B, Sk, KVH, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    q_block: int = 1024,
    kv_block: int = 1024,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    """Online-softmax attention over q blocks and kv blocks, as the
    reference's scan does: every kv block is visited and masked."""
    B, Sq, H, D = q.shape
    _, Sk, KVH, _ = k.shape
    Dv = v.shape[-1]
    G = H // KVH
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    q_block, kv_block = min(q_block, Sq), min(kv_block, Sk)
    qs = (q * scale).reshape(B, Sq, KVH, G, D)
    out = torch.empty(B, Sq, KVH, G, Dv, dtype=q.dtype, device=q.device)
    for q0 in range(0, Sq, q_block):
        qb = qs[:, q0:q0 + q_block]                              # (B,qb,KVH,G,D)
        nq = qb.shape[1]
        q_pos = torch.arange(q0, q0 + nq, device=q.device) + q_offset
        m = torch.full((B, KVH, G, nq), NEG_INF, device=q.device)
        l = torch.zeros(B, KVH, G, nq, device=q.device)
        acc = torch.zeros(B, nq, KVH, G, Dv, device=q.device)
        for k0 in range(0, Sk, kv_block):
            kb, vb = k[:, k0:k0 + kv_block], v[:, k0:k0 + kv_block]
            k_pos = torch.arange(k0, k0 + kb.shape[1], device=q.device)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb.float(), kb.float())
            mask = torch.ones(nq, kb.shape[1], dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= q_pos[:, None] - k_pos[None, :] < window
            s = s.masked_fill(~mask, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + torch.einsum(
                "bhgqk,bkhd->bqhgd", p, vb.float())
            m = m_new
        l = l.permute(0, 3, 1, 2)[..., None]                     # (B,qb,KVH,G,1)
        out[:, q0:q0 + nq] = (acc / l.clamp_min(1e-30)).to(q.dtype)
    return out.reshape(B, Sq, H, Dv)


# ---------------------------------------------------------------------------
# FFN / embeddings / LM head
# ---------------------------------------------------------------------------

def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w_gate) * (x @ w_up)) @ w_down


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return table[tokens].to(dtype)


def lm_logits(x: torch.Tensor, head: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """x: (B, S, d); head: (d, V_pad). float32 logits, with the padded vocab
    columns set to NEG_INF."""
    logits = x.float() @ head.float()
    if head.shape[-1] > vocab_size:
        logits[..., vocab_size:] = NEG_INF
    return logits
