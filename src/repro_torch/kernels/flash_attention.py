"""Binding of ``csrc/flash_attention.cu``, the port of the Pallas kernel
``repro/kernels/flash_attention.py::flash_attention_kernel``.

The kernel reads q (B, Sq, H, D) and k/v (B, Sk, KVH, D) in the model layout
through their strides and writes a contiguous (B, Sq, H, D) output. This
module only marshals arguments; ``ops.flash_attention`` validates them,
builds and loads the library, and counts launches.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "flash_attention.cu"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C symbol -> (restype, argtypes)
SIGNATURES = {
    "flash_attention_fwd": (_I, [_I, _I, _P, _P, _P, _P] + [_I] * 6 + [_L] * 9
                            + [_I, _I, _I, _F, _P]),
}


def launch(lib: ctypes.CDLL, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           out: torch.Tensor, *, dtype_code: int, causal: bool, window: int,
           q_offset: int, scale: float) -> int:
    """Enqueue the kernel on the current stream; returns the C status."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    return lib.flash_attention_fwd(
        dtype_code, q.device.index, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), B, Sq, Sk, H, KVH, D,
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        int(causal), window, q_offset, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
