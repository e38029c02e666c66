"""Binding of ``csrc/decode_attention.cu``, the port of the Pallas kernel
``repro/kernels/decode_attention.py::decode_attention_kernel``.

Split-K flash-decoding: pass 1 writes per-split partial softmax state into
float32 scratch that this module allocates, pass 2 merges it. q (B, 1, H, D)
and the cache (B, S, KVH, D) are read in the model layout through their
strides. ``ops.decode_attention`` validates, builds, loads and counts.
"""
from __future__ import annotations

import ctypes

import torch

SOURCE = "decode_attention.cu"
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C symbol -> (restype, argtypes)
SIGNATURES = {
    "decode_attention_splits": (_I, [_I, _I]),
    "decode_attention_fwd": (_I, [_I, _I] + [_P] * 7 + [_I] * 5 + [_L] * 8
                             + [_I, _F, _P]),
}


def launch(lib: ctypes.CDLL, q: torch.Tensor, k_cache: torch.Tensor,
           v_cache: torch.Tensor, lengths: torch.Tensor, out: torch.Tensor, *,
           dtype_code: int, window: int, scale: float) -> int:
    """Enqueue both passes on the current stream; returns the C status."""
    B, _, H, D = q.shape
    S, KVH = k_cache.shape[1], k_cache.shape[2]
    splits = lib.decode_attention_splits(D, S)
    if splits < 0:
        return splits
    part_ml = torch.empty((B, H, splits, 2), dtype=torch.float32, device=q.device)
    part_acc = torch.empty((B, H, splits, D), dtype=torch.float32, device=q.device)
    return lib.decode_attention_fwd(
        dtype_code, q.device.index, q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), lengths.data_ptr(), part_ml.data_ptr(),
        part_acc.data_ptr(), out.data_ptr(), B, S, H, KVH, D,
        q.stride(0), q.stride(2), *k_cache.stride()[:3], *v_cache.stride()[:3],
        window, scale, torch.cuda.current_stream(q.device).cuda_stream)
