"""PyTorch port of the ``repro`` model zoo and serving fabric, for one NVIDIA
H100.

Subpackages mirror ``repro``'s names one to one
(``repro/models/attention.py`` ↔ ``repro_torch/models/attention.py``). The
Pallas TPU kernels become CUDA C++ kernels for ``sm_90a`` under ``csrc/``,
built at first use (``kernels/ops.py``). This package imports neither
``jax`` nor anything of ``repro``: what it needs from the JAX-free modules
there is copied here (``configs/``, ``core/warming.py``).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
with no card they raise rather than fall back (:func:`resolve_device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
