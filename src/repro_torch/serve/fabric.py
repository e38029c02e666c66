"""Serving fabric, the port of ``repro.serve.fabric``: the torch model zoo
behind funcX's container cache.

Every ``(arch, step, shape-bucket)`` combination is one **warmth key** —
``torch/<arch>/<step>/b<bucket>`` — used as the task's container type. The
prefix differs from the reference's ``jit/`` so that a router never counts
a JAX-warm worker as torch-warm. Building the environment is the cold
start: the weights are made or loaded onto the card, the CUDA kernels are
built and loaded, and the model runs once at the bucket shape. A
:class:`~repro_torch.core.warming.WarmCache` keeps it warm.

:func:`install` registers a ``torch/`` prefix spec factory on a
ContainerRegistry, so each concrete key is minted on first demand. The
serving functions are module-level, so a worker resolves them by
reference. They return numpy arrays, which the reference's wire codec
carries without pickle.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..configs import ModelConfig, get_reduced_config
from ..core.warming import ContainerRegistry, ContainerSpec
from ..device import resolve_device
from ..models import RunKnobs, get_model
from .sampler import sample
from .serve_step import make_decode, make_prefill

TORCH_PREFIX = "torch/"
STEP_KINDS = ("generate", "prefill", "decode")
_MIN_BUCKET = 16
_DECODE_HORIZON = 32           # cache headroom past the prompt


# ---------------------------------------------------------------------------
# warmth keys
# ---------------------------------------------------------------------------

def shape_bucket(prompt_len: int) -> int:
    """Pad bucket for a prompt length: the next power of two (≥ 16)."""
    b = _MIN_BUCKET
    while b < prompt_len:
        b *= 2
    return b


def torch_key(arch: str, step: str = "generate", bucket: int = _MIN_BUCKET) -> str:
    """The warmth key naming one serving environment."""
    if step not in STEP_KINDS:
        raise ValueError(f"unknown step kind {step!r} (one of {STEP_KINDS})")
    return f"{TORCH_PREFIX}{arch}/{step}/b{int(bucket)}"


def parse_torch_key(key: str) -> Tuple[str, str, int]:
    """``torch/<arch>/<step>/b<bucket>`` → ``(arch, step, bucket)``."""
    if not key.startswith(TORCH_PREFIX):
        raise ValueError(f"not a torch warmth key: {key!r}")
    arch, step, bucket = key[len(TORCH_PREFIX):].rsplit("/", 2)
    if step not in STEP_KINDS or not bucket.startswith("b"):
        raise ValueError(f"malformed torch warmth key: {key!r}")
    return arch, step, int(bucket[1:])


def pad_to_bucket(tokens: np.ndarray) -> np.ndarray:
    """Right-pad a ``(B, S)`` prompt with zeros to its shape bucket. As in
    the reference, prefill then reads the next token at the last (pad)
    position for a prompt shorter than its bucket."""
    tokens = np.asarray(tokens)
    bucket = shape_bucket(tokens.shape[1])
    if tokens.shape[1] == bucket:
        return tokens
    pad = np.zeros((tokens.shape[0], bucket - tokens.shape[1]), dtype=tokens.dtype)
    return np.concatenate([tokens, pad], axis=1)


# ---------------------------------------------------------------------------
# container build (the cold start)
# ---------------------------------------------------------------------------

def _build_env(arch: str, step: str, bucket: int, *, cfg: Optional[ModelConfig] = None,
               weights: Any = None, seed: int = 0, device=None) -> Dict[str, Any]:
    """Build one serving environment on ``device`` (default: the card).

    ``cfg`` defaults to the reduced config of ``arch``, as in the
    reference; pass the full one to serve at full width. ``weights`` are
    carried-across JAX params (a nested dict of numpy arrays); without them
    the weights are drawn from a ``torch.Generator`` seeded with ``seed``."""
    cfg = cfg if cfg is not None else get_reduced_config(arch)
    if cfg.name.split("@")[0] != arch:
        raise ValueError(f"config {cfg.name!r} is not of arch {arch!r}")
    dev = resolve_device(device)
    model = get_model(cfg)
    knobs = RunKnobs(q_block=64, kv_block=64)
    if weights is None:
        params = model.init(torch.Generator(device=dev).manual_seed(seed), dev)
    else:
        params = model.load(weights, dev)
    prefill = make_prefill(model, knobs, cache_len=bucket + _DECODE_HORIZON)
    decode = make_decode(model, knobs)
    probe = torch.zeros((1, bucket), dtype=torch.int32, device=dev)
    logits, cache = prefill(params, {"tokens": probe})
    if step != "prefill":                   # the decode path too
        decode(params, cache, {"tokens": probe[:, :1]})
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return {"arch": arch, "step": step, "bucket": bucket, "cfg": cfg,
            "model": model, "params": params, "prefill": prefill,
            "decode": decode, "device": dev, "uses": 0}


def install(registry: ContainerRegistry, **build_kwargs) -> ContainerRegistry:
    """Expose the zoo on ``registry``: any ``torch/...`` type a task asks
    for is minted on first demand. ``build_kwargs`` (``cfg``, ``weights``,
    ``seed``, ``device``) go to every environment build."""
    def spec_for(container_type: str) -> ContainerSpec:
        arch, step, bucket = parse_torch_key(container_type)
        return ContainerSpec(
            container_type, build=lambda: _build_env(arch, step, bucket, **build_kwargs))

    registry.register_factory(TORCH_PREFIX, spec_for)
    return registry


# ---------------------------------------------------------------------------
# serving functions (module-level: resolvable by reference)
# ---------------------------------------------------------------------------

def _prompt(data, env) -> torch.Tensor:
    tokens = pad_to_bucket(np.asarray(data["tokens"]))
    if tokens.shape[1] != env["bucket"]:
        raise ValueError(f"a {tokens.shape[1]}-token bucket sent to the "
                         f"b{env['bucket']} environment")
    return torch.as_tensor(tokens, dtype=torch.int32).to(env["device"])


def _use(env) -> bool:
    """Count one use; True if the environment had served before."""
    uses, env["uses"] = env["uses"], env["uses"] + 1
    return uses > 0


def serve_generate(data, env):
    """Greedy batched generation inside the warm environment. Reports
    ``warm`` from an env-held uses counter."""
    warm = _use(env)
    tokens = _prompt(data, env)
    n_new = int(data.get("n_tokens", 4))
    if not 1 <= n_new <= _DECODE_HORIZON + 1:
        raise ValueError(f"n_tokens must be in [1, {_DECODE_HORIZON + 1}], got {n_new}")
    logits, cache = env["prefill"](env["params"], {"tokens": tokens})
    tok = sample(logits)
    outs = [tok]
    for _ in range(n_new - 1):
        logits, cache = env["decode"](env["params"], cache, {"tokens": tok[:, None]})
        tok = sample(logits)
        outs.append(tok)
    return {"tokens": torch.stack(outs, dim=1).cpu().numpy(), "warm": warm,
            "arch": env["arch"], "bucket": env["bucket"]}


def serve_prefill(data, env):
    """One prefill step: returns the greedy next token."""
    warm = _use(env)
    logits, _cache = env["prefill"](env["params"], {"tokens": _prompt(data, env)})
    return {"next_token": sample(logits).cpu().numpy(), "warm": warm}


def serve_decode(data, env):
    """One decode step after a prefill of the given prompt."""
    warm = _use(env)
    logits, cache = env["prefill"](env["params"], {"tokens": _prompt(data, env)})
    logits, _cache = env["decode"](env["params"], cache, {"tokens": sample(logits)[:, None]})
    return {"next_token": sample(logits).cpu().numpy(), "warm": warm}
