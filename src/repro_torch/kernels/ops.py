"""Model-layout wrappers around the CUDA kernels, and the loader that builds
them.

Each wrapper takes the model layout — (B, S, heads, D) for attention and the
SSD, (B, S, W) for the RG-LRU — as ``repro.kernels.ops`` does, and:

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
from . import rglru_scan as _rglru_mod
from . import ssd_scan as _ssd_mod

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS: Dict[str, ModuleType] = {"flash_attention": _flash_mod,
                                  "decode_attention": _decode_mod,
                                  "ssd_scan": _ssd_mod,
                                  "rglru_scan": _rglru_mod}
# head dims each attention kernel is instantiated for
HEAD_DIMS = {"flash_attention": (16, 32, 64, 128, 256),
             "decode_attention": (16, 32, 64, 128)}
SMEM_PER_BLOCK = 232_448            # bytes of shared memory a block may use on Hopper
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
    the seconds it took and the ``ptxas -v`` lines (entry, registers, spills)."""
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
                                   if any(w in ln for w in ("entry function", "registers",
                                                            "spill"))]}
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


def _dtype_code(name: str, tensors: Dict[str, torch.Tensor]) -> int:
    """The kernel's code for the one dtype ``tensors`` share."""
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or next(iter(dtypes)) not in _DTYPE_CODES:
        raise ValueError(f"{name}: {', '.join(tensors)} must share one dtype of "
                         f"{sorted(map(str, _DTYPE_CODES))}, got {sorted(map(str, dtypes))}")
    return _DTYPE_CODES[next(iter(dtypes))]


def _check_operands(name: str, tensors: Dict[str, torch.Tensor]) -> int:
    code = _dtype_code(name, tensors)
    for arg, t in tensors.items():
        if t.dim() != 4:
            raise ValueError(f"{name}: {arg} must be 4-d (B, S, heads, D), got {tuple(t.shape)}")
        if t.shape[-1] not in HEAD_DIMS[name]:
            raise ValueError(f"{name}: head dim {t.shape[-1]} not supported "
                             f"(the kernel takes {HEAD_DIMS[name]})")
        # the kernels read four elements at a time along D
        if t.stride(-1) != 1 or any(s % 4 for s in t.stride()[:3]) or t.data_ptr() % 16:
            raise ValueError(f"{name}: {arg} needs a contiguous head dim, strides that are "
                             f"multiples of 4 and a 16-byte aligned start, got strides "
                             f"{t.stride()}")
    return code


def _check_contiguous_last(name: str, tensors: Dict[str, torch.Tensor]) -> None:
    for arg, t in tensors.items():
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}: {arg} needs a contiguous last dim, got strides "
                             f"{t.stride()}")


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


def ssd(
    x: torch.Tensor,              # (B, S, H, P) — model layout, dt-scaled
    a: torch.Tensor,              # (B, S, H) float32 log decays
    Bm: torch.Tensor,             # (B, S, H, N); may be a head-broadcast view
    Cm: torch.Tensor,             # (B, S, H, N)
    *,
    chunk: int = 256,
):
    """Mamba-2 SSD scan. Returns (y (B, S, H, P) in x's dtype, final state
    (B, H, P, N) float32)."""
    name = "ssd_scan"
    if _placement(name, [x, a, Bm, Cm]) == "cpu":
        return ref.ssd(x, a, Bm, Cm)
    code = _dtype_code(name, {"x": x, "B": Bm, "C": Cm})
    if a.dtype != torch.float32:
        raise ValueError(f"{name}: a must be float32 (the log decays), got {a.dtype}")
    if x.dim() != 4 or a.shape != x.shape[:3] or Bm.dim() != 4 or Bm.shape != Cm.shape \
            or Bm.shape[:3] != x.shape[:3]:
        raise ValueError(f"{name}: x {tuple(x.shape)}, a {tuple(a.shape)}, B "
                         f"{tuple(Bm.shape)}, C {tuple(Cm.shape)} do not fit (B, S, H, P), "
                         "(B, S, H), (B, S, H, N)")
    _check_contiguous_last(name, {"x": x, "B": Bm, "C": Cm})
    B, S, H, P = x.shape
    if min(B, S, H, P, Bm.shape[-1]) < 1 or chunk < 1:
        raise ValueError(f"{name}: empty shape {tuple(x.shape)}/{tuple(Bm.shape)} or "
                         f"chunk {chunk}")
    chunk = min(int(chunk), S)
    lib = _library(name)
    if lib.ssd_scan_smem_bytes(Bm.shape[-1], chunk) > SMEM_PER_BLOCK:
        raise ValueError(f"{name}: state width {Bm.shape[-1]} with chunk {chunk} needs more "
                         f"than {SMEM_PER_BLOCK} bytes of shared memory per block")
    y = torch.empty((B, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((B, H, P, Bm.shape[-1]), dtype=torch.float32, device=x.device)
    rc = _ssd_mod.launch(lib, x, a, Bm, Cm, y, state, dtype_code=code, chunk=chunk)
    _check_status(name, rc)
    LAUNCHES[name] += 1
    return y, state


def rglru(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """RG-LRU recurrence ``h_t = a_t·h_{t-1} + b_t`` over a, b (B, S, W);
    h (B, S, W) in b's dtype, carried in float32."""
    name = "rglru_scan"
    if _placement(name, [a, b]) == "cpu":
        return ref.rglru(a, b)
    code = _dtype_code(name, {"a": a, "b": b})
    if a.dim() != 3 or a.shape != b.shape or min(a.shape) < 1:
        raise ValueError(f"{name}: a {tuple(a.shape)} and b {tuple(b.shape)} must be one "
                         "non-empty (B, S, W) shape")
    _check_contiguous_last(name, {"a": a, "b": b})
    h = torch.empty(a.shape, dtype=b.dtype, device=b.device)
    rc = _rglru_mod.launch(_library(name), a, b, h, dtype_code=code)
    _check_status(name, rc)
    LAUNCHES[name] += 1
    return h
