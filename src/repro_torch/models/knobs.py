"""Runtime knobs orthogonal to the architecture config — the execution-path
and performance surface (kernel selection, block sizes, remat, loss chunking).
Part of the *compile signature* (funcX container type) together with the
ModelConfig and ShapeConfig.

A copy of ``repro.models.knobs`` with one change: ``use_kernels`` defaults
to True, because the hand-written CUDA kernels are the port's main path.
``use_kernels=False`` selects the plain attention of ``models/common.py``,
which the chip smoke run compares the kernels against."""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class RunKnobs:
    use_kernels: bool = True     # CUDA kernels (kernels/ops.py) vs plain torch
    q_block: int = 1024
    kv_block: int = 1024
    remat: str = "full"          # "none" | "dots" | "full"
    chunked_loss: bool = False   # never materialize (B, S, V) logits
    loss_chunk: int = 512
    causal_skip: bool = False    # skip fully-masked kv blocks in causal attn
    # scan over layers (production) vs unrolled python loop; the port always
    # runs a python loop over layers, so this only travels with the key.
    scan_layers: bool = True
    # ANALYSIS-ONLY in the reference (attention-core stub for roofline
    # differencing); the port does not read it.
    attn_stub: bool = False


DEFAULT_KNOBS = RunKnobs()
