"""Binding of ``csrc/ssd_scan.cu``, the port of the Pallas kernel
``repro/kernels/ssd_scan.py::ssd_scan_kernel``.

The kernel reads x (B, S, H, P), a (B, S, H) and B/C (B, S, H, N) in the
model layout through their strides — B and C may be broadcast views with
head stride 0 — and writes a contiguous y (B, S, H, P) and f32 state
(B, H, P, N). This module only marshals arguments; ``ops.ssd`` validates
them, builds and loads the library, and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "ssd_scan.cu"
_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# C symbol -> (restype, argtypes)
SIGNATURES = {
    "ssd_scan_smem_bytes": (_I, [_I, _I]),
    "ssd_scan_fwd": (_I, [_I, _I] + [_P] * 6 + [_I] * 6 + [_L] * 12 + [_P]),
}


def launch(lib: ctypes.CDLL, x: torch.Tensor, a: torch.Tensor, Bm: torch.Tensor,
           Cm: torch.Tensor, y: torch.Tensor, state: torch.Tensor, *, dtype_code: int,
           chunk: int) -> int:
    """Enqueue the kernel on the current stream; returns the C status."""
    B, S, H, P = x.shape
    return lib.ssd_scan_fwd(
        dtype_code, x.device.index, x.data_ptr(), a.data_ptr(), Bm.data_ptr(),
        Cm.data_ptr(), y.data_ptr(), state.data_ptr(), B, S, H, P, Bm.shape[-1], chunk,
        *x.stride()[:3], *a.stride(), *Bm.stride()[:3], *Cm.stride()[:3],
        torch.cuda.current_stream(x.device).cuda_stream)
