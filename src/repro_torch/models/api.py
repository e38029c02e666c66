"""Unified model API, the port of ``repro.models.api``.

``get_model(cfg)`` returns a :class:`Model` facade dispatching to the family
implementation, as the reference's does: the dense decoder
(``transformer``), Mamba-2 (``ssm``) and the RecurrentGemma hybrid
(``rglru``). The other families raise ``NotImplementedError`` naming the
ROADMAP item that ports them.

The reference keeps float32 master weights and casts them to ``cfg.dtype``
at every call (``Model._cast``). The port serves only, so it casts once,
when the weights are made or loaded: the computation sees the same values.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..configs import ModelConfig
from ..device import resolve_device
from . import params as P
from . import rglru, ssm, transformer
from .knobs import DEFAULT_KNOBS, RunKnobs


def _unported(cfg: ModelConfig) -> Optional[str]:
    """The ROADMAP item that ports ``cfg``'s family, or None if it is ported."""
    if cfg.mla is not None:
        return "Queue A item 9 (MLA)"
    if cfg.family == "vlm" or cfg.vlm is not None:
        return "Queue A item 10 (VLM)"
    if cfg.family == "moe" or cfg.moe is not None:
        return "Queue A item 11 (MoE)"
    if cfg.family == "audio":
        return "Queue A item 13 (encoder-decoder)"
    return None


def _family_module(cfg: ModelConfig):
    if cfg.family == "ssm":
        return ssm
    if cfg.family == "hybrid":
        return rglru
    return transformer       # dense


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        item = _unported(self.cfg)
        if item is not None:
            raise NotImplementedError(
                f"{self.cfg.name} (family {self.cfg.family}) is not ported to "
                f"repro_torch yet: ROADMAP {item}")

    @property
    def mod(self):
        return _family_module(self.cfg)

    @property
    def dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.dtype)

    # ---- parameters --------------------------------------------------------
    def spec(self) -> dict:
        return self.mod.model_spec(self.cfg)

    def param_count(self) -> int:
        return P.count_params(self.spec())

    def init(self, gen: Optional[torch.Generator] = None, device=None) -> Any:
        """Fresh weights in ``cfg.dtype`` on ``device`` (default: the card),
        drawn from ``gen`` (default: seed 0). The ``meta`` device allocates
        nothing."""
        dev = resolve_device(device)
        if gen is None and dev.type != "meta":
            gen = torch.Generator(device=dev).manual_seed(0)
        return P.init_params(self.spec(), gen, dev, self.dtype)

    def load(self, tree_of_numpy: Any, device=None) -> Any:
        """Weights carried across from the JAX side (``np.asarray`` of each
        leaf of ``repro``'s params) → ``cfg.dtype`` on ``device``."""
        _check_shapes(self.spec(), tree_of_numpy)
        return P.load_jax_params(tree_of_numpy, resolve_device(device), self.dtype)

    # ---- computations ------------------------------------------------------
    def prefill(self, params, batch, knobs: RunKnobs = DEFAULT_KNOBS,
                cache_len: Optional[int] = None) -> Tuple[torch.Tensor, dict]:
        with torch.inference_mode():
            return self.mod.prefill(self.cfg, params, batch, knobs, cache_len=cache_len)

    def decode_step(self, params, cache, batch,
                    knobs: RunKnobs = DEFAULT_KNOBS) -> Tuple[torch.Tensor, dict]:
        with torch.inference_mode():
            return self.mod.decode_step(self.cfg, params, cache, batch, knobs)

    # ---- caches ------------------------------------------------------------
    def init_cache(self, batch: int, max_seq: int, device=None,
                   dtype: Optional[torch.dtype] = None) -> dict:
        return self.mod.init_cache(self.cfg, batch, max_seq, dtype or self.dtype,
                                      resolve_device(device))


def _check_shapes(spec: dict, tree: Any) -> None:
    want = {p: s.shape for p, s in P.leaves_with_paths(spec)}
    got = {p: tuple(np.shape(a)) for p, a in P.leaves_with_paths(tree)}
    if want != got:
        diff = sorted(set(want.items()) ^ set(got.items()))
        raise ValueError(f"weights do not fit the model's spec: {diff[:6]}")


def get_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
