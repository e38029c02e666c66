"""Model-layout wrappers around the CUDA kernels, and the loader that builds
them.

Each wrapper takes the model layout (B, S, heads, D), as
``repro.kernels.ops`` does, and:

- runs the plain PyTorch version (``ref.py``) when its tensors lie on the
  CPU;
- on CUDA tensors checks device, dtype, shape, strides and alignment,
  launches the hand-written kernel, adds one to ``LAUNCHES[name]``, and
  raises on anything the kernel does not take. It never falls back to the
  plain version on the card.

The kernels are compiled from ``csrc/`` with ``nvcc`` for ``sm_90a`` into
shared libraries with a C interface, loaded with ``ctypes``, at first use.
The libraries go to ``build/kernels/`` at the root of the checkout, named by
a digest of their sources, so an edited source is rebuilt.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, Iterable, List, Optional

import torch

from . import decode_attention as _decode_mod
from . import flash_attention as _flash_mod
from . import ref

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS: Dict[str, ModuleType] = {"flash_attention": _flash_mod,
                                  "decode_attention": _decode_mod}
HEAD_DIMS = (64, 128)
MAX_GROUP = 8                       # query heads per kv head the decode kernel takes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# Launches of each kernel since the last reset_launches(); the chip smoke run
# reads them to show the main path went through the kernels.
LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_libs: Dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# build + load
# ---------------------------------------------------------------------------

def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and on PATH); "
                           "the CUDA kernels are built at first use")
    return found


def library_path(name: str) -> Path:
    """Where the library of kernel ``name`` lives: named by a digest of its
    source and the shared header, so editing either rebuilds it."""
    h = hashlib.sha256()
    for src in [CSRC / KERNELS[name].SOURCE, *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet, one
    ``nvcc`` per source, all started together. Returns, per kernel built,
    the seconds it took and the ``ptxas -v`` lines (registers, spills)."""
    names = list(KERNELS if names is None else names)
    with _build_lock:
        todo = [n for n in names if not library_path(n).exists()]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        t0 = time.perf_counter()
        for n in todo:
            out = library_path(n)
            tmp = out.with_suffix(f".tmp{os.getpid()}")
            cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                   "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
                   "-I", str(CSRC), "-o", str(tmp), str(CSRC / KERNELS[n].SOURCE)]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True), tmp, out)
        report, failed = {}, []
        for n, (proc, tmp, out) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{n}:\n{log}")
                continue
            os.replace(tmp, out)
            report[n] = {"seconds": time.perf_counter() - t0,
                         "ptxas": [ln.strip() for ln in log.splitlines()
                                   if "registers" in ln or "spill" in ln]}
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return report


def _library(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        for sym, (restype, argtypes) in KERNELS[name].SIGNATURES.items():
            fn = getattr(lib, sym)
            fn.restype, fn.argtypes = restype, argtypes
        _libs[name] = lib
    return lib


# ---------------------------------------------------------------------------
# checks
# ---------------------------------------------------------------------------

def _placement(name: str, tensors: List[torch.Tensor]) -> str:
    """"cpu" or "cuda" for a call whose tensors all lie on one device."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev.type


def _check_operands(name: str, tensors: Dict[str, torch.Tensor]) -> int:
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODES:
        raise ValueError(f"{name}: operands must share one dtype of "
                         f"{sorted(map(str, _DTYPE_CODES))}, got {sorted(map(str, dtypes))}")
    for arg, t in tensors.items():
        if t.dim() != 4:
            raise ValueError(f"{name}: {arg} must be 4-d (B, S, heads, D), got {tuple(t.shape)}")
        if t.shape[-1] not in HEAD_DIMS:
            raise ValueError(f"{name}: head dim {t.shape[-1]} not supported "
                             f"(the kernel takes {HEAD_DIMS})")
        # the kernels read four elements at a time along D
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} needs a contiguous head dim, strides that are "
                             f"multiples of 4 and a 16-byte aligned start, got strides "
                             f"{t.stride()}")
    return _DTYPE_CODES[next(iter(dtypes))]


def _check_status(name: str, rc: int) -> None:
    if rc != 0:
        what = "shape not supported" if rc < 0 else f"CUDA error {rc}"
        raise RuntimeError(f"{name}: kernel launch failed ({what})")


def _window_arg(name: str, window: Optional[int]) -> int:
    if window is None:
        return 0
    if window < 1:
        raise ValueError(f"{name}: window must be >= 1, got {window}")
    return int(window)


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def flash_attention(
    q: torch.Tensor,              # (B, Sq, H, D) — model layout
    k: torch.Tensor,              # (B, Sk, KVH, D)
    v: torch.Tensor,              # (B, Sk, KVH, D)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    name = "flash_attention"
    if _placement(name, [q, k, v]) == "cpu":
        return ref.flash_attention(q, k, v, causal=causal, window=window,
                                   q_offset=q_offset, softmax_scale=softmax_scale)
    code = _check_operands(name, {"q": q, "k": k, "v": v})
    B, Sq, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D or H % k.shape[2]:
        raise ValueError(f"{name}: q {tuple(q.shape)} and k/v {tuple(k.shape)}/"
                         f"{tuple(v.shape)} do not fit (B, S, H, D) / (B, S, KVH, D) "
                         "with KVH dividing H")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty((B, Sq, H, D), dtype=q.dtype, device=q.device)
    rc = _flash_mod.launch(_library(name), q, k, v, out, dtype_code=code,
                           causal=causal, window=_window_arg(name, window),
                           q_offset=int(q_offset), scale=float(scale))
    _check_status(name, rc)
    LAUNCHES[name] += 1
    return out


def decode_attention(
    q: torch.Tensor,              # (B, 1, H, D) — model layout
    k_cache: torch.Tensor,        # (B, S, KVH, D)
    v_cache: torch.Tensor,        # (B, S, KVH, D)
    lengths: torch.Tensor,        # (B,) int32
    *,
    window: Optional[int] = None,
    softmax_scale: Optional[float] = None,
) -> torch.Tensor:
    name = "decode_attention"
    if _placement(name, [q, k_cache, v_cache, lengths]) == "cpu":
        return ref.decode_attention(q, k_cache, v_cache, lengths, window=window,
                                    softmax_scale=softmax_scale)
    code = _check_operands(name, {"q": q, "k_cache": k_cache, "v_cache": v_cache})
    B, one, H, D = q.shape
    if (one != 1 or k_cache.shape != v_cache.shape or k_cache.shape[0] != B
            or k_cache.shape[3] != D or H % k_cache.shape[2]):
        raise ValueError(f"{name}: q {tuple(q.shape)} and cache {tuple(k_cache.shape)}/"
                         f"{tuple(v_cache.shape)} do not fit (B, 1, H, D) / (B, S, KVH, D) "
                         "with KVH dividing H")
    if H // k_cache.shape[2] > MAX_GROUP:
        raise ValueError(f"{name}: {H // k_cache.shape[2]} query heads per kv head; "
                         f"the kernel takes at most {MAX_GROUP}")
    if lengths.dtype != torch.int32 or lengths.shape != (B,) or not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be a contiguous int32 ({B},) tensor, got "
                         f"{lengths.dtype} {tuple(lengths.shape)}")
    scale = softmax_scale if softmax_scale is not None else D ** -0.5
    out = torch.empty((B, 1, H, D), dtype=q.dtype, device=q.device)
    rc = _decode_mod.launch(_library(name), q, k_cache, v_cache, lengths, out,
                            dtype_code=code, window=_window_arg(name, window),
                            scale=float(scale))
    _check_status(name, rc)
    LAUNCHES[name] += 1
    return out
