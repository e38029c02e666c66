#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Runs from any directory: it finds ``src/`` beside this file. It builds the
CUDA kernels from the checkout's sources, holds each against its plain
PyTorch version, serves full-width qwen1.5-0.5b through the port's main
path (``serve_step.generate`` and the fabric), and times each kernel at the
main path's shapes. It prints one JSON line per phase; before the last line
the card's name and power limit and a JSON object with one entry per
kernel; last, ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero. With no card, or without the checkout around it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import platform
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

ARCH = "qwen1.5-0.5b"
BATCH, PROMPT, NEW_TOKENS = 4, 512, 64
FABRIC_REQUESTS, FABRIC_TOKENS = 4, 16
DECODE_CACHE = 544                 # the fabric's cache at bucket 512: 512 + 32 slots
TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2e-2, 2e-2)}   # tests/test_kernels.py:17-19
MODEL_TOL = (0.08, 0.05)           # bf16 decode, tests/test_models_consistency.py:60
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor-core bf16; f32 CUDA cores
SLEEP_CYCLES = 100_000_000         # ~50 ms: the host enqueues a timed loop behind it

# Sweeps of tests/test_kernels.py:24-113. The kernels take head dims 64 and
# 128 only; the sweep's cases at head dim 32 and 16 run at 64 here, and one
# case per kernel checks that head dim 32 is refused.
# (B, Sq, Sk, H, KVH, D, causal, window)
FLASH_CASES = [
    (1, 64, 64, 4, 4, 64, True, None),       # MHA, square
    (2, 128, 128, 8, 2, 64, True, None),     # GQA 4:1
    (1, 96, 200, 4, 1, 64, True, None),      # MQA, ragged kv, q_offset = 104
    (2, 1, 160, 8, 4, 128, True, None),      # one query
    (2, 128, 128, 4, 2, 64, True, 16),       # sliding window
    (2, 128, 128, 4, 2, 64, True, 64),
    (1, 48, 72, 4, 4, 64, False, None),      # non-causal
    (2, 100, 100, 8, 4, 64, True, None),     # the chunked-path comparison shape
    (BATCH, PROMPT, PROMPT, 16, 16, 64, True, None),   # main path: prefill
]
# (B, H, KVH, D, S, window, lengths or None for random)
DECODE_CASES = [
    (2, 4, 4, 64, 128, None, None),          # MHA
    (3, 8, 2, 64, 300, None, None),          # GQA, ragged cache
    (1, 4, 1, 128, 1024, None, None),        # MQA, long cache
    (2, 4, 2, 64, 256, 64, [256, 100]),      # window
    # main path: generate's last step (cache of prompt + new tokens), then
    # the fabric's cache read in full (timed below)
    (BATCH, 16, 16, 64, PROMPT + NEW_TOKENS, None, [PROMPT + NEW_TOKENS - 1] * BATCH),
    (BATCH, 16, 16, 64, DECODE_CACHE, None, [DECODE_CACHE] * BATCH),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def max_err(out, exp):
    return float((out.float() - exp.float()).abs().max())


def allclose(out, exp, atol, rtol) -> bool:
    out, exp = out.float(), exp.float()
    return bool(((out - exp).abs() <= atol + rtol * exp.abs()).all())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env(torch):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    from repro_torch.kernels.ops import nvcc_path
    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    props = torch.cuda.get_device_properties(0)
    # float32 products in full float32 on both sides of every comparison
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    emit({"phase": "env", "card": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
          "nvcc": nvcc, "python": platform.python_version(),
          "sm": f"{props.major}.{props.minor}", "sms": props.multi_processor_count})
    return smi


def phase_build(ops):
    t0 = time.perf_counter()
    report = ops.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0, "kernels": report})


def flash_inputs(torch, gen, case, dtype):
    B, Sq, Sk, H, KVH, D = case[:6]
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    return mk(B, Sq, H, D), mk(B, Sk, KVH, D), mk(B, Sk, KVH, D)


def decode_inputs(torch, gen, case, dtype):
    B, H, KVH, D, S, _window, lengths = case
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(dtype)
    if lengths is None:
        lens = torch.randint(1, S + 1, (B,), generator=gen, device="cuda", dtype=torch.int32)
    else:
        lens = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    return mk(B, 1, H, D), mk(B, S, KVH, D), mk(B, S, KVH, D), lens


def phase_kernels(torch, ops, ref):
    """Each kernel against its plain version on the card, over the sweeps."""
    gen = torch.Generator(device="cuda").manual_seed(7)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        tname = str(dtype).split(".")[1]
        atol, rtol = TOL[tname]
        for i, case in enumerate(FLASH_CASES):
            causal, window = case[6], case[7]
            q, k, v = flash_inputs(torch, gen, case, dtype)
            off = k.shape[1] - q.shape[1] if causal else 0
            out = ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
            exp = ref.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            emit({"phase": "kernels", "kernel": "flash_attention", "dtype": tname,
                  "case": list(case[:6]), "causal": causal, "window": window,
                  "q_offset": off, "max_abs_err": err, "tol": [atol, rtol]})
            check(allclose(out, exp, atol, rtol), f"flash_attention {case} {tname}")
            errs[("flash_attention", tname, i)] = err
        for i, case in enumerate(DECODE_CASES):
            q, kc, vc, lens = decode_inputs(torch, gen, case, dtype)
            out = ops.decode_attention(q, kc, vc, lens, window=case[5])
            exp = ref.decode_attention(q, kc, vc, lens, window=case[5])
            torch.cuda.synchronize()
            err = max_err(out, exp)
            emit({"phase": "kernels", "kernel": "decode_attention", "dtype": tname,
                  "case": list(case[:5]), "window": case[5], "lengths": lens.tolist(),
                  "max_abs_err": err, "tol": [atol, rtol]})
            check(allclose(out, exp, atol, rtol), f"decode_attention {case} {tname}")
            errs[("decode_attention", tname, i)] = err
    # what the kernels do not take, they refuse
    x = torch.zeros(1, 16, 2, 32, device="cuda")
    for name, call in (("flash_attention", lambda: ops.flash_attention(x, x, x)),
                       ("decode_attention", lambda: ops.decode_attention(
                           x[:, :1], x, x, torch.full((1,), 16, dtype=torch.int32,
                                                      device="cuda")))):
        try:
            call()
        except ValueError as e:
            emit({"phase": "kernels", "kernel": name, "refused": "head dim 32", "error": str(e)})
        else:
            check(False, f"{name} took head dim 32")
    return errs


def phase_serve(torch, ops):
    """Full-width qwen1.5-0.5b through serve_step.generate on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import RunKnobs, get_model
    from repro_torch.serve.serve_step import generate, make_decode, make_prefill

    cfg = get_config(ARCH)
    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens}

    # logits through the kernels against the plain attention, prefill and
    # four teacher-forced decode steps
    kern, plain = RunKnobs(), RunKnobs(use_kernels=False)
    lk, ck = model.prefill(params, batch, kern, cache_len=PROMPT + 8)
    lp, cp = model.prefill(params, batch, plain, cache_len=PROMPT + 8)
    errs, ok = [max_err(lk, lp)], allclose(lk, lp, *MODEL_TOL)
    for _ in range(4):
        tok = lk.argmax(-1).to(torch.int32)[:, None]
        lk, ck = model.decode_step(params, ck, {"tokens": tok}, kern)
        lp, cp = model.decode_step(params, cp, {"tokens": tok}, plain)
        errs.append(max_err(lk, lp))
        ok = ok and allclose(lk, lp, *MODEL_TOL)
    check(bool(torch.isfinite(lk[:, :cfg.vocab_size]).all()), "non-finite logits")
    emit({"phase": "serve", "check": "logits through the kernels vs plain attention",
          "max_abs_err": errs, "tol": list(MODEL_TOL)})
    check(ok, f"kernel-path logits differ from the plain path: {errs}")

    generate(model, params, {"tokens": tokens[:, :64]}, 2)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = generate(model, params, batch, NEW_TOKENS)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = {"flash_attention": cfg.n_layers,
            "decode_attention": cfg.n_layers * (NEW_TOKENS - 1)}
    check(launches == want, f"main-path launches {launches}, expected {want}")
    check(tuple(out.shape) == (BATCH, NEW_TOKENS), f"generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), "tokens outside the vocab")
    peak = torch.cuda.max_memory_allocated()

    prefill = make_prefill(model, cache_len=PROMPT + NEW_TOKENS)
    decode = make_decode(model)
    pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(params, batch)
        torch.cuda.synchronize()
        pre.append((time.perf_counter() - t0) * 1e3)
    tok = logits.argmax(-1).to(torch.int32)[:, None]
    t0 = time.perf_counter()
    for _ in range(NEW_TOKENS - 1):
        logits, cache = decode(params, cache, {"tokens": tok})
        tok = logits.argmax(-1).to(torch.int32)[:, None]
    torch.cuda.synchronize()
    decode_ms = (time.perf_counter() - t0) * 1e3 / (NEW_TOKENS - 1)
    prof = profile(torch, lambda: prefill(params, batch), "prefill")
    prof_d = profile(torch, lambda: decode(params, cache, {"tokens": tok}), "decode_step")
    # the profiler's own host cost inflates its wall time: the idle share of
    # the unprofiled call takes the wall time measured above
    for p, wall_ms in ((prof, sorted(pre)[1]), (prof_d, decode_ms)):
        busy = p["device_busy_ms"]
        p["idle_share_unprofiled"] = None if busy is None else 1 - busy / wall_ms
    emit({"phase": "serve", "arch": ARCH, "dtype": cfg.dtype, "batch": BATCH,
          "prompt": PROMPT, "new_tokens": NEW_TOKENS, "params": model.param_count(),
          "init_s": load_s, "launches": launches, "generate_ms": generate_s * 1e3,
          "prefill_ms": sorted(pre)[1], "decode_ms_per_token": decode_ms,
          "tokens_per_s": BATCH * NEW_TOKENS / generate_s, "max_memory_allocated": peak,
          "first_tokens": out[:, :8].tolist(), "profile": [prof, prof_d]})
    return launches


def profile(torch, fn, name):
    """Device busy time and kernel count of one call, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile

    fn()
    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in p.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"call": name, "wall_ms": wall_us / 1e3,
            "device_busy_ms": busy_us / 1e3 if kernels else None,
            "idle_share": 1 - busy_us / wall_us if kernels else None,
            "kernels": len(kernels), "top_ms": [[n[:80], t / 1e3] for n, t in top]}


def phase_fabric(torch, ops):
    """install + WarmCache at full width: one cold request, three warm."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_requests

    cfg = get_config(ARCH)
    ops.reset_launches()
    res = serve_requests(ARCH, prompt_len=PROMPT, n_tokens=FABRIC_TOKENS, batch=BATCH,
                         requests=FABRIC_REQUESTS, full=True, seed=0, device="cuda")
    launches = dict(ops.LAUNCHES)
    key = f"torch/{ARCH}/generate/b{PROMPT}"
    # the build runs one prefill and one decode step at the bucket shape
    want = {"flash_attention": cfg.n_layers * (1 + FABRIC_REQUESTS),
            "decode_attention": cfg.n_layers * (1 + FABRIC_REQUESTS * (FABRIC_TOKENS - 1))}
    emit({"phase": "fabric", "key": key, "launches": launches,
          "requests": [{k: r[k] for k in ("request", "cold", "warm", "ms", "build_s")}
                       for r in res],
          "tokens": res[0]["tokens"][:2, :8].tolist()})
    check(all(r["key"] == key for r in res), "warmth key")
    check([r["cold"] for r in res] == [True] + [False] * (FABRIC_REQUESTS - 1), "cold flags")
    check([r["warm"] for r in res] == [False] + [True] * (FABRIC_REQUESTS - 1), "warm flags")
    check(launches == want, f"fabric launches {launches}, expected {want}")
    for r in res:
        t = r["tokens"]
        check(t.shape == (BATCH, FABRIC_TOKENS) and ((t >= 0) & (t < cfg.vocab_size)).all(),
              "fabric tokens")


def time_ms(torch, fn, sets, iters=40):
    """Device milliseconds per call: the loop is enqueued behind a sleep
    kernel, so the events time the device running the calls back to back,
    not the host launching them. Inputs cycle over ``sets``, which together
    exceed the 50 MB L2, as the layers of a model do."""
    for s in sets[:3]:
        fn(*s)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for i in range(iters):
        fn(*sets[i % len(sets)])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def phase_timings(torch, ops, ref, launches, errs):
    import torch.nn.functional as F
    gen = torch.Generator(device="cuda").manual_seed(11)
    dtype, tname = torch.bfloat16, "bfloat16"
    rows = []

    case = FLASH_CASES[-1]
    B, Sq, Sk, H, KVH, D = case[:6]
    sets = [flash_inputs(torch, gen, case, dtype) for _ in range(5)]     # 5 x 12.6 MB
    ms = time_ms(torch, lambda q, k, v: ops.flash_attention(q, k, v), sets)
    plain = time_ms(torch, lambda q, k, v: ref.flash_attention(q, k, v), sets)
    lib = time_ms(torch, lambda q, k, v: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True), sets)
    nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KVH * D)          # q, k, v in; o out
    pairs = B * H * Sq * (Sq + 1) // 2                                 # causal (q, k) pairs
    rows.append(_row("flash_attention", "src/repro/kernels/flash_attention.py:141",
                     launches, errs[("flash_attention", tname, len(FLASH_CASES) - 1)], ms, plain, lib,
                     nbytes, 4 * D * pairs, tname,
                     {"shape": list(case[:6]), "dtype": tname, "causal": True}))

    case = DECODE_CASES[-1]
    B, H, KVH, D, S = case[:5]
    sets = [decode_inputs(torch, gen, case, dtype) for _ in range(8)]   # 8 x 8.9 MB
    ms = time_ms(torch, lambda q, k, v, n: ops.decode_attention(q, k, v, n), sets)
    plain = time_ms(torch, lambda q, k, v, n: ref.decode_attention(q, k, v, n), sets)
    # SDPA takes the lengths as a boolean mask, made outside the timed loop
    masked = [(q, k, v, (torch.arange(S, device="cuda")[None] < n[:, None])[:, None, None])
              for q, k, v, n in sets]
    lib = time_ms(torch, lambda q, k, v, m: F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), attn_mask=m), masked)
    live = int(sets[0][3].sum())                                        # cache rows read
    nbytes = 2 * (2 * B * H * D + 2 * live * KVH * D) + 4 * B           # q, o; k, v; lengths
    rows.append(_row("decode_attention", "src/repro/kernels/decode_attention.py:100",
                     launches, errs[("decode_attention", tname, len(DECODE_CASES) - 1)], ms, plain, lib,
                     nbytes, 4 * D * H * live, tname,
                     {"shape": list(case[:5]), "dtype": tname, "lengths": case[6]}))
    for r in rows:
        emit({"phase": "timings", **r})
    return rows


def _row(name, replaces, launches, err, ms, plain, lib, nbytes, flops, tname, extra):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[tname] * 1e3
    return {"name": name, "route": "cuda", "source": f"src/repro_torch/csrc/{name}.cu",
            "replaces": replaces, "launches": launches[name], "max_abs_err": err,
            "ms": ms, "plain_ms": plain, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib, "bytes": nbytes, "flops": flops, **extra}


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found: run from a checkout",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops, ref

    t_start = time.perf_counter()
    smi = phase_env(torch)
    phase_build(ops)
    errs = phase_kernels(torch, ops, ref)
    launches = phase_serve(torch, ops)
    phase_fabric(torch, ops)
    rows = phase_timings(torch, ops, ref, launches, errs)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi)
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
