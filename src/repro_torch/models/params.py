"""Parameter-spec system, the port of ``repro.models.params``.

Every model declares its parameters once, as a nested dict of
:class:`ParamSpec`. The trees have the same key paths and shapes as the JAX
side (``tree_paths`` strings equal ``repro.models.params.tree_paths``), so
weights carry across leaf by leaf (:func:`load_jax_params`).

Weights must be carried across rather than re-drawn: the JAX init seeds each
leaf with ``hash(path_str)``, which changes with ``PYTHONHASHSEED``, and
``jax.random`` and ``torch.Generator`` give different numbers anyway. Here a
fresh init draws the leaves from one ``torch.Generator``, one after another.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Iterator, NamedTuple, Optional, Tuple

import numpy as np
import torch


class ParamSpec(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"        # "normal" | "zeros" | "ones" | "const" | "scaled_normal"
    scale: float = 0.02

    def stacked(self, n: int) -> "ParamSpec":
        return ParamSpec((n,) + self.shape, ("layers",) + self.axes, self.init, self.scale)


def map_tree(fn: Callable[[Any], Any], tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves_with_paths(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """``(keystr, leaf)`` pairs in the order ``jax.tree_util`` flattens a
    dict tree (keys sorted), with JAX's ``keystr`` spelling."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{prefix}[{k!r}]")
    else:
        yield prefix, tree


def stack(spec_tree: Any, n: int) -> Any:
    """Prepend a ('layers') dimension to every spec in the tree."""
    return map_tree(lambda s: s.stacked(n), spec_tree)


def tree_paths(spec_tree: Any) -> Dict[str, ParamSpec]:
    return dict(leaves_with_paths(spec_tree))


def count_params(spec_tree: Any) -> int:
    return sum(math.prod(s.shape) for _, s in leaves_with_paths(spec_tree))


def _init_leaf(spec: ParamSpec, gen: Optional[torch.Generator],
               device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    if device.type == "meta":
        return torch.empty(spec.shape, device=device, dtype=dtype)
    if spec.init == "zeros":
        return torch.zeros(spec.shape, device=device, dtype=dtype)
    if spec.init == "ones":
        return torch.ones(spec.shape, device=device, dtype=dtype)
    if spec.init == "const":
        return torch.full(spec.shape, spec.scale, device=device, dtype=dtype)
    if spec.init == "normal":
        std = spec.scale
    elif spec.init == "scaled_normal":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.randn(spec.shape, generator=gen, device=device, dtype=torch.float32)
    return (x * std).to(dtype)


def init_params(spec_tree: Any, gen: Optional[torch.Generator],
                device: torch.device, dtype: torch.dtype) -> Any:
    """Materialize parameters, drawing the leaves from ``gen`` one after
    another (``gen`` must live on ``device``; the ``meta`` device allocates
    nothing and draws nothing)."""
    return map_tree(lambda s: _init_leaf(s, gen, device, dtype), spec_tree)


# ---------------------------------------------------------------------------
# weight bridge
# ---------------------------------------------------------------------------

def _from_numpy(a: np.ndarray) -> torch.Tensor:
    # torch wants writable memory; arrays viewed from JAX buffers are not
    a = np.require(a, requirements=["C", "W"])
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: go through its bits
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def load_jax_params(tree: Any, device: torch.device,
                    dtype: Optional[torch.dtype] = None) -> Any:
    """A nested dict of numpy arrays (``np.asarray`` of each JAX leaf) →
    the port's params on ``device``, float leaves cast to ``dtype`` when
    given. bf16 leaves keep their exact bits."""
    def leaf(a):
        t = _from_numpy(a).to(device)
        return t.to(dtype) if dtype is not None and t.is_floating_point() else t
    return map_tree(leaf, tree)


def export_params(tree: Any) -> Any:
    """The port's params → nested dict of numpy arrays. bf16 leaves come out
    as their ``uint16`` bit patterns (numpy has no bfloat16 of its own)."""
    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16)
        return t.numpy()
    return map_tree(leaf, tree)
