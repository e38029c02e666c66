"""Binding of ``csrc/rglru_scan.cu``, the port of the Pallas kernel
``repro/kernels/rglru_scan.py::rglru_scan_kernel``.

The kernel reads a and b (B, S, W) through their batch and time strides
and writes a contiguous h (B, S, W). This module only marshals arguments;
``ops.rglru`` validates them, builds and loads the library, and counts
launches.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "rglru_scan.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C symbol -> (restype, argtypes)
SIGNATURES = {
    "rglru_scan_fwd": (_I, [_I, _I, _P, _P, _P] + [_I] * 3 + [_L] * 4 + [_P]),
}


def launch(lib: ctypes.CDLL, a: torch.Tensor, b: torch.Tensor, h: torch.Tensor, *,
           dtype_code: int) -> int:
    """Enqueue the kernel on the current stream; returns the C status."""
    B, S, W = a.shape
    return lib.rglru_scan_fwd(
        dtype_code, a.device.index, a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W,
        a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        torch.cuda.current_stream(a.device).cuda_stream)
