"""Mamba-2 (SSD — state-space duality) blocks, the port of
``repro.models.ssm``. Attention-free mixer.

Prefill runs the chunked SSD: within a chunk the quadratic "attention dual"
form, across chunks the state recurrence. ``knobs.use_kernels`` (the port's
default) sends it to the CUDA kernel ``ops.ssd``; ``use_kernels=False`` runs
the plain chunked :func:`ssd_scan` here, which the chip smoke run compares
the kernel path against. Decode is the O(1) recurrence
``h = exp(dt·A)·h + dt·B⊗x`` (:func:`ssd_step`), which has no kernel.

A Python loop over layers replaces ``scan``; the per-layer parameters are
views into the stacked ``(L, ...)`` leaves, so the tree keeps the
reference's paths. The cache keeps the reference's stacked layout
``{"ssm": (L, B, H, P, N), "conv": (L, B, W-1, C)}``; decode updates it in
place.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs import ModelConfig
from ..kernels import ops
from .common import embed_tokens, lm_logits, rms_norm
from .knobs import DEFAULT_KNOBS, RunKnobs
from .params import ParamSpec, stack
from .transformer import _layer


# ---------------------------------------------------------------------------
# Spec
# ---------------------------------------------------------------------------

def _dims(cfg: ModelConfig):
    s = cfg.ssm
    return s, s.d_inner(cfg.d_model), s.n_heads(cfg.d_model), s.head_dim, s.n_groups * s.d_state


def block_spec(cfg: ModelConfig) -> dict:
    s, d_in, H, P, gn = _dims(cfg)
    d = cfg.d_model
    return {
        "ln": ParamSpec((d,), ("embed",), "zeros"),
        "w_z": ParamSpec((d, d_in), ("embed", "ssm_inner"), "scaled_normal"),
        "w_x": ParamSpec((d, d_in), ("embed", "ssm_inner"), "scaled_normal"),
        "w_B": ParamSpec((d, gn), ("embed", None), "scaled_normal"),
        "w_C": ParamSpec((d, gn), ("embed", None), "scaled_normal"),
        "w_dt": ParamSpec((d, H), ("embed", None), "scaled_normal"),
        "conv_x": ParamSpec((s.d_conv, d_in), (None, "ssm_inner"), "scaled_normal"),
        "conv_B": ParamSpec((s.d_conv, gn), (None, None), "scaled_normal"),
        "conv_C": ParamSpec((s.d_conv, gn), (None, None), "scaled_normal"),
        "A_log": ParamSpec((H,), (None,), "zeros"),
        "D": ParamSpec((H,), (None,), "ones"),
        "dt_bias": ParamSpec((H,), (None,), "zeros"),
        "gate_norm": ParamSpec((d_in,), ("ssm_inner",), "zeros"),
        "w_out": ParamSpec((d_in, d), ("ssm_inner", "embed"), "scaled_normal"),
    }


def model_spec(cfg: ModelConfig) -> dict:
    v = cfg.padded_vocab()
    return {
        "embed": {"tok": ParamSpec((v, cfg.d_model), ("vocab", "embed"), "normal", 0.02)},
        "blocks": stack(block_spec(cfg), cfg.n_layers),
        "ln_f": ParamSpec((cfg.d_model,), ("embed",), "zeros"),
        "lm_head": ParamSpec((cfg.d_model, v), ("embed", "vocab"), "scaled_normal"),
    }


# ---------------------------------------------------------------------------
# Causal depthwise conv (shift-sum form, in the reference's order)
# ---------------------------------------------------------------------------

def causal_conv(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """x: (B, S, C); kernel: (W, C). y[t] = sum_w k[w] * x[t - (W-1) + w]."""
    W = kernel.shape[0]
    out = x * kernel[W - 1]
    for w in range(W - 1):
        shift = W - 1 - w
        shifted = F.pad(x, (0, 0, shift, 0))[:, :-shift]
        out = out + shifted * kernel[w]
    return out


def conv_step(window: torch.Tensor, kernel: torch.Tensor, x_new: torch.Tensor):
    """window: (B, W-1, C) past inputs; x_new: (B, 1, C).
    Returns (y (B, 1, C), new window)."""
    full = torch.cat([window, x_new], dim=1)                     # (B, W, C)
    y = torch.einsum("bwc,wc->bc", full, kernel)[:, None]
    return y, full[:, 1:]


# ---------------------------------------------------------------------------
# SSD core: the plain chunked scan and the one-token step
# ---------------------------------------------------------------------------

def _exp(t: torch.Tensor) -> torch.Tensor:
    return torch.exp(t.float())


def ssd_scan(
    x: torch.Tensor,              # (B, S, H, P) dt-scaled inputs
    a: torch.Tensor,              # (B, S, H) log decays (dt * A, negative)
    Bm: torch.Tensor,             # (B, S, H, N)
    Cm: torch.Tensor,             # (B, S, H, N)
    chunk: int,
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD in plain PyTorch, as the reference's, but with the
    in-chunk prefix sums of the log decays in f64 (the CUDA kernel's too).
    Returns (y (B,S,H,P), final state (B,H,P,N))."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    chunk = min(chunk, S)
    pad = (-S) % chunk
    if pad:
        # a=0 → decay 1 and x=0 → no state contribution: exact padding
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        a = F.pad(a, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, 0, 0, pad))
    nc = (S + pad) // chunk
    xr = x.reshape(Bsz, nc, chunk, H, P)
    ar = a.reshape(Bsz, nc, chunk, H).float()
    Br = Bm.reshape(Bsz, nc, chunk, H, N)
    Cr = Cm.reshape(Bsz, nc, chunk, H, N)
    h = torch.zeros(Bsz, H, P, N, dtype=torch.float32, device=x.device) if h0 is None else h0
    mask = torch.tril(torch.ones(chunk, chunk, dtype=torch.bool, device=x.device))
    ys = []
    for ci in range(nc):
        xq, aq, bq, cq = xr[:, ci].float(), ar[:, ci], Br[:, ci].float(), Cr[:, ci].float()
        # the prefix sums reach ~-200 over a 256-token chunk: in f32 their
        # differences would keep only ~4 digits, so they are taken in f64
        a_cum = torch.cumsum(aq.double(), dim=1)                 # (B,q,H)
        # intra-chunk (dual "attention" form): decay(i<-j) = exp(acum_i - acum_j)
        scores = torch.einsum("bihn,bjhn->bhij", cq, bq)
        decay = _exp(a_cum[:, :, None] - a_cum[:, None, :]).permute(0, 3, 1, 2)
        L = torch.where(mask, scores * decay, 0.0)
        y_intra = torch.einsum("bhij,bjhp->bihp", L, xq)
        # inter-chunk: y_i += (C_i · h_prev) * exp(acum_i)
        y_inter = torch.einsum("bihn,bhpn->bihp", cq, h) * _exp(a_cum)[..., None]
        # state update
        chunk_decay = _exp(a_cum[:, -1])                         # (B,H)
        in_decay = _exp(a_cum[:, -1:, :] - a_cum)                # (B,q,H)
        dh = torch.einsum("bqhn,bqhp,bqh->bhpn", bq, xq, in_decay)
        h = chunk_decay[:, :, None, None] * h + dh
        ys.append((y_intra + y_inter).to(x.dtype))
    y = torch.cat(ys, dim=1)[:, :S]
    return y, h


def ssd_step(h: torch.Tensor, x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
             Cm: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence. h (B,H,P,N); x (B,H,P); a (B,H);
    Bm/Cm (B,H,N). Returns (y (B,H,P), h_new)."""
    h_new = torch.exp(a)[..., None, None] * h + torch.einsum(
        "bhp,bhn->bhpn", x.float(), Bm.float())
    y = torch.einsum("bhpn,bhn->bhp", h_new, Cm.float())
    return y.to(x.dtype), h_new


# ---------------------------------------------------------------------------
# Block forward
# ---------------------------------------------------------------------------

def _proj_inputs(cfg: ModelConfig, p: dict, h: torch.Tensor):
    """Shared between full and step paths. h already normed."""
    return h @ p["w_z"], h @ p["w_x"], h @ p["w_B"], h @ p["w_C"], h @ p["w_dt"]


def _by_head(m: torch.Tensor, cfg: ModelConfig, H: int) -> torch.Tensor:
    """(B, S, G·N) → (B, S, H, N), group g serving heads g·H/G … The
    reference ``jnp.repeat``s; with one group this is a view of head stride
    0, which the kernel reads without a copy."""
    s = cfg.ssm
    Bsz, S = m.shape[:2]
    m = m.reshape(Bsz, S, s.n_groups, s.d_state)
    if s.n_groups == 1:
        return m.expand(Bsz, S, H, s.d_state)
    return m.repeat_interleave(H // s.n_groups, dim=2)


def _gates(cfg: ModelConfig, p: dict, x, Bm, Cm, dt):
    """Post-conv activations + continuous-time discretization."""
    s, d_in, H, P, gn = _dims(cfg)
    Bsz, S = x.shape[:2]
    x, Bm, Cm = F.silu(x), F.silu(Bm), F.silu(Cm)
    dt = F.softplus(dt.float() + p["dt_bias"])                   # (B,S,H) f32
    A = -torch.exp(p["A_log"].float())                           # (H,)
    a = dt * A                                                   # log decay
    xh = x.reshape(Bsz, S, H, P)
    x_dt = xh * dt[..., None].to(xh.dtype)
    return xh, x_dt, a, _by_head(Bm, cfg, H), _by_head(Cm, cfg, H)


def _mix_out(cfg: ModelConfig, p: dict, y, xh, z, x_res):
    """Skip term, gated norm, output projection and residual."""
    s, d_in, H, P, gn = _dims(cfg)
    y = y + p["D"][None, None, :, None] * xh
    y = y.reshape(*x_res.shape[:2], d_in)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    return x_res + y @ p["w_out"]


def block_full(cfg: ModelConfig, p: dict, x_res: torch.Tensor, knobs: RunKnobs,
               collect_state: bool = False):
    s, d_in, H, P, gn = _dims(cfg)
    h = rms_norm(x_res, p["ln"], cfg.norm_eps)
    z, x, Bm, Cm, dt = _proj_inputs(cfg, p, h)
    conv_in = torch.cat([x, Bm, Cm], dim=-1) if collect_state else None
    x = causal_conv(x, p["conv_x"])
    Bm = causal_conv(Bm, p["conv_B"])
    Cm = causal_conv(Cm, p["conv_C"])
    xh, x_dt, a, Bh, Ch = _gates(cfg, p, x, Bm, Cm, dt)
    if knobs.use_kernels:
        y, h_final = ops.ssd(x_dt, a, Bh, Ch, chunk=s.chunk_size)
    else:
        y, h_final = ssd_scan(x_dt, a, Bh, Ch, chunk=s.chunk_size)
    out = _mix_out(cfg, p, y, xh, z, x_res)
    if collect_state:
        return out, {"ssm": h_final, "conv": conv_in[:, -(s.d_conv - 1):]}
    return out, None


def block_step(cfg: ModelConfig, p: dict, x_res: torch.Tensor, cache: dict):
    """x_res: (B, 1, d). cache: {"ssm": (B,H,P,N), "conv": (B,W-1,C)}."""
    s, d_in, H, P, gn = _dims(cfg)
    h = rms_norm(x_res, p["ln"], cfg.norm_eps)
    z, x, Bm, Cm, dt = _proj_inputs(cfg, p, h)
    conv_in = torch.cat([x, Bm, Cm], dim=-1)                     # (B,1,C)
    kernel = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    y_conv, new_window = conv_step(cache["conv"], kernel, conv_in)
    x, Bm, Cm = torch.split(y_conv, [d_in, gn, gn], dim=-1)
    xh, x_dt, a, Bh, Ch = _gates(cfg, p, x, Bm, Cm, dt)
    y, h_new = ssd_step(cache["ssm"], x_dt[:, 0], a[:, 0], Bh[:, 0], Ch[:, 0])
    return _mix_out(cfg, p, y[:, None], xh, z, x_res), {"ssm": h_new, "conv": new_window}


# ---------------------------------------------------------------------------
# Model-level API (serving; loss_fn waits for the train step)
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype: torch.dtype,
               device: torch.device) -> dict:
    s, d_in, H, P, gn = _dims(cfg)
    L = cfg.n_layers
    return {
        "layers": {
            "ssm": torch.zeros((L, batch, H, P, s.d_state), dtype=torch.float32, device=device),
            "conv": torch.zeros((L, batch, s.d_conv - 1, d_in + 2 * gn), dtype=dtype,
                                device=device),
        },
        "pos": 0,
        "lengths": torch.zeros(batch, dtype=torch.int32, device=device),
    }


def prefill(cfg: ModelConfig, params: dict, batch: Dict[str, torch.Tensor],
            knobs: RunKnobs = DEFAULT_KNOBS,
            cache_len: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
    """Full-sequence forward; returns (last-position logits, the state
    cache). ``cache_len`` is accepted and ignored: the state has no length."""
    tokens = batch["tokens"]
    x = embed_tokens(params["embed"]["tok"], tokens, getattr(torch, cfg.dtype))
    B, S = tokens.shape
    states = []
    for i in range(cfg.n_layers):
        x, st = block_full(cfg, _layer(params, i), x, knobs, collect_state=True)
        states.append(st)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = lm_logits(x[:, -1:], params["lm_head"], cfg.vocab_size)
    cache = {"layers": {k: torch.stack([st[k] for st in states]) for k in ("ssm", "conv")},
             "pos": S,
             "lengths": torch.full((B,), S, dtype=torch.int32, device=tokens.device)}
    return logits[:, 0], cache


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: Dict[str, torch.Tensor],
                knobs: RunKnobs = DEFAULT_KNOBS) -> Tuple[torch.Tensor, dict]:
    """One token for every sequence. The stacked layer states are updated in
    place; the returned dict carries the new position and lengths."""
    x = embed_tokens(params["embed"]["tok"], batch["tokens"], getattr(torch, cfg.dtype))
    layers = cache["layers"]
    for i in range(cfg.n_layers):
        x, st = block_step(cfg, _layer(params, i), x,
                           {"ssm": layers["ssm"][i], "conv": layers["conv"][i]})
        layers["ssm"][i] = st["ssm"]
        layers["conv"][i] = st["conv"]
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = lm_logits(x, params["lm_head"], cfg.vocab_size)
    return logits[:, 0], {"layers": layers, "pos": cache["pos"] + 1,
                          "lengths": cache["lengths"] + 1}
