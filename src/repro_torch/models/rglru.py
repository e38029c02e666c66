"""RecurrentGemma / Griffin hybrid, the port of ``repro.models.rglru``:
RG-LRU recurrent blocks and local (sliding-window) attention blocks in a
2:1 pattern.

Layer layout for L layers: ``head = L % 3`` leading recurrent blocks, then
``L // 3`` super-blocks of (attention, recurrent, recurrent), the
reference's rotation of the paper's r, r, a sequence.

``knobs.use_kernels`` (the port's default) sends the prefill recurrence to
the CUDA kernel ``ops.rglru`` and the local attention to
``ops.flash_attention``; ``use_kernels=False`` runs the plain sequential
recurrence and the plain chunked attention. Decode is the O(1) recurrence
plus a rolling, end-aligned window KV cache attended with the reference's
own einsum (no kernel on that step, as in the reference).

A Python loop over layers replaces ``scan``; the cache keeps the
reference's stacked layout and decode updates it in place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import ModelConfig
from ..kernels import ops, ref
from . import attention as attn
from .common import NEG_INF, apply_rope, embed_tokens, lm_logits, rms_norm
from .knobs import DEFAULT_KNOBS, RunKnobs
from .params import ParamSpec, map_tree, stack
from .ssm import causal_conv, conv_step

RG_C = 8.0          # RG-LRU decay sharpness constant (Griffin §2.4)
LAMBDA_INIT = -4.6  # softplus(Λ)≈0.01 → per-step decay a ≈ exp(-0.08·r)


# ---------------------------------------------------------------------------
# Specs
# ---------------------------------------------------------------------------

def _gelu_ffn_spec(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": ParamSpec((d, f), ("embed", "ffn"), "scaled_normal"),
        "w_up": ParamSpec((d, f), ("embed", "ffn"), "scaled_normal"),
        "w_down": ParamSpec((f, d), ("ffn", "embed"), "scaled_normal"),
    }


def rec_block_spec(cfg: ModelConfig) -> dict:
    r = cfg.recurrent
    d, lru = cfg.d_model, r.lru_width
    nb = cfg.n_heads                      # block-diagonal gate blocks
    bs = lru // nb
    return {
        "ln1": ParamSpec((d,), ("embed",), "zeros"),
        "w_x": ParamSpec((d, lru), ("embed", "lru_width"), "scaled_normal"),
        "w_gate": ParamSpec((d, lru), ("embed", "lru_width"), "scaled_normal"),
        "conv": ParamSpec((r.conv1d_width, lru), (None, "lru_width"), "scaled_normal"),
        "rg_a_w": ParamSpec((nb, bs, bs), ("act_heads", None, None), "scaled_normal"),
        "rg_a_b": ParamSpec((lru,), ("lru_width",), "zeros"),
        "rg_x_w": ParamSpec((nb, bs, bs), ("act_heads", None, None), "scaled_normal"),
        "rg_x_b": ParamSpec((lru,), ("lru_width",), "zeros"),
        "lam": ParamSpec((lru,), ("lru_width",), "const", LAMBDA_INIT),
        "w_out": ParamSpec((lru, d), ("lru_width", "embed"), "scaled_normal"),
        "ln2": ParamSpec((d,), ("embed",), "zeros"),
        "ffn": _gelu_ffn_spec(cfg),
    }


def attn_block_spec(cfg: ModelConfig) -> dict:
    return {
        "ln1": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
        "attn": attn.attn_spec(cfg),
        "ln2": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
        "ffn": _gelu_ffn_spec(cfg),
    }


def _layout(cfg: ModelConfig) -> Tuple[int, int]:
    return cfg.n_layers % 3, cfg.n_layers // 3


def model_spec(cfg: ModelConfig) -> dict:
    head, n_sb = _layout(cfg)
    v = cfg.padded_vocab()
    spec = {
        "embed": {"tok": ParamSpec((v, cfg.d_model), ("vocab", "embed"), "normal", 0.02)},
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
    }
    if head:
        spec["head_rec"] = stack(rec_block_spec(cfg), head)
    if n_sb:
        spec["sb"] = stack({"attn": attn_block_spec(cfg),
                            "rec": stack(rec_block_spec(cfg), 2)}, n_sb)
    if not cfg.tie_embeddings:
        spec["lm_head"] = ParamSpec((cfg.d_model, v), ("embed", "vocab"), "scaled_normal")
    return spec


# ---------------------------------------------------------------------------
# RG-LRU core
# ---------------------------------------------------------------------------

def _blockdiag(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """x: (B, S, lru); w: (nb, bs, bs); b: (lru,)."""
    B, S, lru = x.shape
    nb, bs, _ = w.shape
    y = torch.einsum("bshi,hij->bshj", x.reshape(B, S, nb, bs), w).reshape(B, S, lru)
    return y + b


def rglru_gates(p: dict, x: torch.Tensor):
    """x: (B, S, lru) post-conv. Returns (log_a f32, beta·x f32)."""
    r = torch.sigmoid(_blockdiag(x, p["rg_a_w"], p["rg_a_b"]).float())
    i = torch.sigmoid(_blockdiag(x, p["rg_x_w"], p["rg_x_b"]).float())
    log_a = -RG_C * F.softplus(p["lam"].float()) * r
    beta = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12))
    return log_a, beta * i * x.float()


def rglru_full(p: dict, x: torch.Tensor, use_kernel: bool = True):
    """Linear recurrence over the sequence. Returns (h (B,S,lru) in x's
    dtype, h_last (B, lru) f32)."""
    log_a, bx = rglru_gates(p, x)
    scan = ops.rglru if use_kernel else ref.rglru
    h = scan(torch.exp(log_a), bx)
    return h.to(x.dtype), h[:, -1]


def rglru_step(p: dict, x: torch.Tensor, h_prev: torch.Tensor):
    """x: (B, 1, lru); h_prev: (B, lru) f32."""
    log_a, bx = rglru_gates(p, x)
    h = torch.exp(log_a[:, 0]) * h_prev + bx[:, 0]
    return h.to(x.dtype)[:, None], h


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def _gelu_ffn(p: dict, x: torch.Tensor) -> torch.Tensor:
    return (_gelu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]


def _rec_tail(cfg: ModelConfig, p: dict, x_res, hr, gate):
    x_res = x_res + (hr * gate) @ p["w_out"]
    return x_res + _gelu_ffn(p["ffn"], rms_norm(x_res, p["ln2"], cfg.norm_eps))


def rec_block_full(cfg: ModelConfig, p: dict, x_res, knobs: RunKnobs, collect: bool = False):
    h = rms_norm(x_res, p["ln1"], cfg.norm_eps)
    gate = _gelu(h @ p["w_gate"])
    conv_in = h @ p["w_x"]
    hr, h_last = rglru_full(p, causal_conv(conv_in, p["conv"]), use_kernel=knobs.use_kernels)
    state = None
    if collect:
        state = {"h": h_last, "conv": conv_in[:, -(cfg.recurrent.conv1d_width - 1):]}
    return _rec_tail(cfg, p, x_res, hr, gate), state


def rec_block_step(cfg: ModelConfig, p: dict, x_res, cache: dict):
    h = rms_norm(x_res, p["ln1"], cfg.norm_eps)
    gate = _gelu(h @ p["w_gate"])
    y_conv, new_window = conv_step(cache["conv"], p["conv"], h @ p["w_x"])
    hr, h_new = rglru_step(p, y_conv, cache["h"])
    return _rec_tail(cfg, p, x_res, hr, gate), {"h": h_new, "conv": new_window}


def attn_block_full(cfg: ModelConfig, p: dict, x_res, positions, knobs: RunKnobs,
                    collect: bool = False):
    W = cfg.recurrent.attention_window
    h = rms_norm(x_res, p["ln1"], cfg.norm_eps)
    a, (k, v) = attn.attn_full(cfg, p["attn"], h, positions, knobs, window=W,
                               return_kv=True)
    state = None
    if collect:
        S = h.shape[1]
        if S >= W:
            kw, vw = k[:, -W:], v[:, -W:]
        else:                             # left-padded: the window cache is end-aligned
            kw, vw = (F.pad(t, (0, 0, 0, 0, W - S, 0)) for t in (k, v))
        state = {"k": kw, "v": vw}
    x_res = x_res + a
    return x_res + _gelu_ffn(p["ffn"], rms_norm(x_res, p["ln2"], cfg.norm_eps)), state


def attn_block_step(cfg: ModelConfig, p: dict, x_res, cache: dict, pos: int):
    """Rolling (end-aligned) window cache: shift left, append at the end."""
    W = cfg.recurrent.attention_window
    B = x_res.shape[0]
    h = rms_norm(x_res, p["ln1"], cfg.norm_eps)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=h.device)
    q, k, v = attn._qkv(cfg, p["attn"], h)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    k_cache = torch.cat([cache["k"][:, 1:], k.to(cache["k"].dtype)], dim=1)
    v_cache = torch.cat([cache["v"][:, 1:], v.to(cache["v"].dtype)], dim=1)
    filled = min(pos + 1, W)
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    qh = (q * hd ** -0.5).reshape(B, KVH, H // KVH, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qh.float(), k_cache.float())
    s[..., :W - filled] = NEG_INF                    # slots not yet written
    pr = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", pr, v_cache.float())
    x_res = x_res + out.reshape(B, 1, H * hd).to(h.dtype) @ p["attn"]["wo"]
    x_res = x_res + _gelu_ffn(p["ffn"], rms_norm(x_res, p["ln2"], cfg.norm_eps))
    return x_res, {"k": k_cache, "v": v_cache}


# ---------------------------------------------------------------------------
# Stack plumbing
# ---------------------------------------------------------------------------

def _idx(tree, *i):
    return map_tree(lambda t: t[i], tree)


def _stack_forward(cfg: ModelConfig, params: dict, x, positions, knobs: RunKnobs,
                   collect: bool = False):
    head, n_sb = _layout(cfg)
    head_states, sb_states = [], []
    for i in range(head):
        x, st = rec_block_full(cfg, _idx(params["head_rec"], i), x, knobs, collect)
        head_states.append(st)
    for i in range(n_sb):
        x, a_st = attn_block_full(cfg, _idx(params["sb"]["attn"], i), x, positions, knobs,
                                  collect)
        r_sts = []
        for j in range(2):
            x, r_st = rec_block_full(cfg, _idx(params["sb"]["rec"], i, j), x, knobs, collect)
            r_sts.append(r_st)
        sb_states.append((a_st, r_sts))
    return rms_norm(x, params["ln_f"], cfg.norm_eps), head_states, sb_states


def _head_w(cfg: ModelConfig, params: dict) -> torch.Tensor:
    if cfg.tie_embeddings:
        return params["embed"]["tok"].T
    return params["lm_head"]


def _embed(cfg: ModelConfig, params: dict, tokens: torch.Tensor) -> torch.Tensor:
    dtype = getattr(torch, cfg.dtype)
    x = embed_tokens(params["embed"]["tok"], tokens, dtype)
    # gemma scaling by sqrt(d_model), rounded to the activation dtype as the
    # reference's jnp.asarray(..., dtype) is; a Python float keeps it off the device
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=dtype).item()


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def _stacked(states, key):
    return torch.stack([st[key] for st in states])


def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device) -> dict:
    head, n_sb = _layout(cfg)
    r, W = cfg.recurrent, cfg.recurrent.attention_window
    kv = (batch, W, cfg.n_kv_heads, cfg.head_dim_)

    def rec(*n):
        return {"h": torch.zeros(n + (batch, r.lru_width), dtype=torch.float32, device=device),
                "conv": torch.zeros(n + (batch, r.conv1d_width - 1, r.lru_width), dtype=dtype,
                                    device=device)}

    cache = {"pos": 0, "lengths": torch.zeros(batch, dtype=torch.int32, device=device)}
    if head:
        cache["head_rec"] = rec(head)
    if n_sb:
        cache["sb"] = {"attn": {"k": torch.zeros((n_sb,) + kv, dtype=dtype, device=device),
                                "v": torch.zeros((n_sb,) + kv, dtype=dtype, device=device)},
                       "rec": rec(n_sb, 2)}
    return cache


def prefill(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
            knobs: RunKnobs = DEFAULT_KNOBS,
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward; returns (last-position logits, cache). The
    window cache has W slots whatever ``cache_len`` says, as in the reference."""
    head, n_sb = _layout(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    positions = torch.arange(S, dtype=torch.int32, device=tokens.device)[None].expand(B, S)
    x, head_states, sb_states = _stack_forward(cfg, params, _embed(cfg, params, tokens),
                                               positions, knobs, collect=True)
    logits = lm_logits(x[:, -1:], _head_w(cfg, params), cfg.vocab_size)
    cache = {"pos": S, "lengths": torch.full((B,), S, dtype=torch.int32, device=tokens.device)}
    if head:
        cache["head_rec"] = {k: _stacked(head_states, k) for k in ("h", "conv")}
    if n_sb:
        attn_states = [a for a, _ in sb_states]
        cache["sb"] = {
            "attn": {k: _stacked(attn_states, k) for k in ("k", "v")},
            "rec": {k: torch.stack([_stacked(r, k) for _, r in sb_states])
                    for k in ("h", "conv")}}
    return logits[:, 0], cache


def _write(dst: dict, src: dict, *i) -> None:
    for k, t in src.items():
        dst[k][i] = t


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: Dict[str, torch.Tensor],
                knobs: RunKnobs = DEFAULT_KNOBS) -> Tuple[torch.Tensor, dict]:
    """One token for every sequence. The stacked caches are updated in
    place; the returned dict carries the new position and lengths."""
    head, n_sb = _layout(cfg)
    x = _embed(cfg, params, batch["tokens"])
    pos = cache["pos"]
    for i in range(head):
        x, st = rec_block_step(cfg, _idx(params["head_rec"], i), x, _idx(cache["head_rec"], i))
        _write(cache["head_rec"], st, i)
    for i in range(n_sb):
        x, a_st = attn_block_step(cfg, _idx(params["sb"]["attn"], i), x,
                                  _idx(cache["sb"]["attn"], i), pos)
        _write(cache["sb"]["attn"], a_st, i)
        for j in range(2):
            x, r_st = rec_block_step(cfg, _idx(params["sb"]["rec"], i, j), x,
                                     _idx(cache["sb"]["rec"], i, j))
            _write(cache["sb"]["rec"], r_st, i, j)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = lm_logits(x, _head_w(cfg, params), cfg.vocab_size)
    new_cache = {k: v for k, v in cache.items() if k in ("head_rec", "sb")}
    new_cache.update(pos=pos + 1, lengths=cache["lengths"] + 1)
    return logits[:, 0], new_cache
