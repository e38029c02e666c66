#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA H100.

    python3 chip_smoke.py

Runs from any directory: it finds ``src/`` beside this file. It builds the
four CUDA kernels from the checkout's sources (flash and decode attention,
the Mamba-2 SSD scan, the RG-LRU scan), holds each against its plain
PyTorch version, serves full-width qwen1.5-0.5b, mamba2-370m and
recurrentgemma-9b through the port's main path (``serve_step.generate``
and the fabric) with exact kernel launch counts, and times each kernel at
the main path's shapes. It prints one JSON line per phase; before the last
line the card's name and power limit and a JSON object with one entry per
kernel row; last, ``{"ok": true, "device": {...}}``. Any failed check
exits non-zero. With no card, or without the checkout around it, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import platform
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
sys.path.insert(0, str(SRC))

QWEN, MAMBA, RGEMMA = "qwen1.5-0.5b", "mamba2-370m", "recurrentgemma-9b"
BATCH, PROMPT, NEW_TOKENS = 4, 512, 64
FABRIC_TOKENS = 16
FABRIC_REQUESTS = {QWEN: 4, MAMBA: 4, RGEMMA: 2}
DECODE_CACHE = 544                 # the fabric's cache at bucket 512: 512 + 32 slots
TOL = {"float32": (3e-5, 3e-5), "bfloat16": (2e-2, 2e-2)}   # tests/test_kernels.py:17-19
SSD_TOL = (5e-4, 5e-4)             # tests/test_kernels.py:159
MODEL_TOL = (0.08, 0.05)           # bf16 decode, tests/test_models_consistency.py:60
# In bf16 the kernel and plain paths of the deep recurrent stacks drift apart:
# their f32 sums differ in order, a y that lands near a bf16 rounding boundary
# flips by one ulp, and 48 (38) layers of random weights compound the flips
# (mamba2-370m: max-abs 0.43 at a logit scale of 5; the same models in f32 agree
# to 1.3e-4). There the bf16 check holds the max-abs error to this share of the
# largest |logit|; the f32 run is held to MODEL_TOL.
BF16_DRIFT = 0.15
HBM_BYTES_PER_S = 3.35e12          # H100 SXM data sheet
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}   # dense tensor-core bf16; f32 CUDA cores
SLEEP_CYCLES = 100_000_000         # ~50 ms: the host enqueues a timed loop behind it
KERNEL_NAMES = ("flash_attention", "decode_attention", "ssd_scan", "rglru_scan")

# Sweeps of tests/test_kernels.py:24-174 at their own head dims, the reduced
# configs' head dim 16, recurrentgemma's head dim 256 (MQA, window 2048 —
# longer than the prompt — and a window shorter than it), and the main
# paths' shapes.
# (B, Sq, Sk, H, KVH, D, causal, window)
FLASH_CASES = [
    (1, 64, 64, 4, 4, 32, True, None),       # MHA, square
    (2, 128, 128, 8, 2, 64, True, None),     # GQA 4:1
    (1, 96, 200, 4, 1, 64, True, None),      # MQA, ragged kv, q_offset = 104
    (2, 1, 160, 8, 4, 128, True, None),      # one query
    (2, 128, 128, 4, 2, 32, True, 16),       # sliding window
    (2, 128, 128, 4, 2, 32, True, 64),
    (1, 48, 72, 4, 4, 64, False, None),      # non-causal
    (2, 100, 100, 8, 4, 64, True, None),     # the chunked-path comparison shape
    (2, 16, 16, 4, 4, 16, True, None),       # reduced qwen1.5-0.5b
    (2, 16, 16, 4, 1, 16, True, 16),         # reduced recurrentgemma-9b
    (2, 300, 300, 16, 1, 256, True, 128),    # recurrentgemma: window < S
    (BATCH, PROMPT, PROMPT, 16, 1, 256, True, 2048),   # main path: recurrentgemma prefill
    (BATCH, PROMPT, PROMPT, 16, 16, 64, True, None),   # main path: qwen prefill
]
FLASH_QWEN, FLASH_RG = len(FLASH_CASES) - 1, len(FLASH_CASES) - 2
# (B, H, KVH, D, S, window, lengths or None for random)
DECODE_CASES = [
    (2, 4, 4, 32, 128, None, None),          # MHA
    (3, 8, 2, 64, 300, None, None),          # GQA, ragged cache
    (1, 4, 1, 128, 1024, None, None),        # MQA, long cache
    (2, 4, 2, 64, 256, 64, [256, 100]),      # window
    (2, 4, 4, 16, 48, None, None),           # reduced qwen1.5-0.5b
    # main path: generate's last step (cache of prompt + new tokens), then
    # the fabric's cache read in full (timed below)
    (BATCH, 16, 16, 64, PROMPT + NEW_TOKENS, None, [PROMPT + NEW_TOKENS - 1] * BATCH),
    (BATCH, 16, 16, 64, DECODE_CACHE, None, [DECODE_CACHE] * BATCH),
]
# (B, S, H, P, N, chunk): tests/test_kernels.py:146-166, the reduced config,
# the fabric's buckets (chunk = min(256, S)) at full width, its B=1 probe,
# and the main path (mamba2-370m, B=4, S=512)
SSD_CASES = [
    (1, 64, 2, 16, 16, 16), (2, 70, 4, 32, 64, 32), (1, 256, 2, 64, 128, 128),
    (2, 96, 2, 16, 32, 32),
    (2, 16, 8, 16, 16, 16),
    (1, 16, 32, 64, 128, 16), (1, 32, 32, 64, 128, 32), (1, 64, 32, 64, 128, 64),
    (1, 128, 32, 64, 128, 128), (1, 512, 32, 64, 128, 256),
    (BATCH, PROMPT, 32, 64, 128, 256),
]
# (B, S, W): tests/test_kernels.py:118-120 and the main path (recurrentgemma-9b)
RGLRU_CASES = [(1, 64, 128), (2, 100, 96), (3, 17, 64), (BATCH, PROMPT, 4096)]


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


def zero_launches(**counts):
    want = dict.fromkeys(KERNEL_NAMES, 0)
    want.update(counts)
    return want


def free(torch):
    gc.collect()
    torch.cuda.empty_cache()


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
    check(set(ops.KERNELS) == set(KERNEL_NAMES), f"kernels {sorted(ops.KERNELS)}")


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


def ssd_inputs(torch, gen, case, dtype):
    """x, a (f32, negative), and B, C with one group broadcast to every head
    (head stride 0), as the model hands them to the kernel."""
    B, S, H, P, N = case[:5]
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    a = -torch.nn.functional.softplus(mk(B, S, H))
    return (mk(B, S, H, P).to(dtype), a, mk(B, S, 1, N).to(dtype).expand(B, S, H, N),
            mk(B, S, 1, N).to(dtype).expand(B, S, H, N))


def rglru_inputs(torch, gen, case, dtype):
    mk = lambda *s: torch.randn(*s, generator=gen, device="cuda")
    return torch.sigmoid(mk(*case)).to(dtype), mk(*case).to(dtype)


def phase_kernels(torch, ops, ref):
    """Each kernel against its plain version on the card, over the sweeps."""
    from repro_torch.models.ssm import ssd_scan
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
        # y in x's dtype: f32 at the SSD tolerance, bf16 at the bf16 one (one
        # rounding of an f32 sum); the f32 state at the SSD tolerance
        y_tol = SSD_TOL if dtype == torch.float32 else TOL[tname]
        for i, case in enumerate(SSD_CASES):
            x, a, Bm, Cm = ssd_inputs(torch, gen, case, dtype)
            y, st = ops.ssd(x, a, Bm, Cm, chunk=case[5])
            worst = 0.0
            for what, (ye, se) in (("ref.ssd", ref.ssd(x, a, Bm, Cm)),
                                   ("ssm.ssd_scan", ssd_scan(x, a, Bm, Cm, chunk=case[5]))):
                torch.cuda.synchronize()
                err = [max_err(y, ye), max_err(st, se)]
                emit({"phase": "kernels", "kernel": "ssd_scan", "dtype": tname, "against": what,
                      "case": list(case), "max_abs_err": err, "tol": [list(y_tol),
                                                                      list(SSD_TOL)]})
                check(allclose(y, ye, *y_tol) and allclose(st, se, *SSD_TOL),
                      f"ssd_scan {case} {tname} against {what}")
                worst = max(worst, *err)
            errs[("ssd_scan", tname, i)] = worst
        for i, case in enumerate(RGLRU_CASES):
            a, b = rglru_inputs(torch, gen, case, dtype)
            out, exp = ops.rglru(a, b), ref.rglru(a, b)
            torch.cuda.synchronize()
            err = max_err(out, exp)
            emit({"phase": "kernels", "kernel": "rglru_scan", "dtype": tname,
                  "case": list(case), "max_abs_err": err, "tol": [atol, rtol]})
            check(out.dtype == dtype and allclose(out, exp, atol, rtol),
                  f"rglru_scan {case} {tname}")
            errs[("rglru_scan", tname, i)] = err
    # what the kernels do not take, they refuse
    x = torch.zeros(1, 16, 2, 48, device="cuda")
    for name, call in (("flash_attention", lambda: ops.flash_attention(x, x, x)),
                       ("decode_attention", lambda: ops.decode_attention(
                           x[:, :1], x, x, torch.full((1,), 16, dtype=torch.int32,
                                                      device="cuda"))),
                       ("ssd_scan", lambda: ops.ssd(x, x[..., 0].half(), x, x)),
                       ("rglru_scan", lambda: ops.rglru(x[0], x[0].bfloat16()))):
        try:
            call()
        except ValueError as e:
            emit({"phase": "kernels", "kernel": name, "refused": True, "error": str(e)})
        else:
            check(False, f"{name} took what it should refuse")
    return errs


# the main path's launches: one generate of NEW_TOKENS tokens (one prefill,
# NEW_TOKENS - 1 decode steps); the fabric adds its build's probe prefill
# and decode step, then FABRIC_TOKENS tokens per request
def generate_launches(cfg, new_tokens):
    if cfg.family == "ssm":                    # decode runs ssd_step, no kernel
        return zero_launches(ssd_scan=cfg.n_layers)
    if cfg.family == "hybrid":                 # decode attends with its own einsum
        n_attn = cfg.n_layers // 3
        return zero_launches(flash_attention=n_attn, rglru_scan=cfg.n_layers - n_attn)
    return zero_launches(flash_attention=cfg.n_layers,
                         decode_attention=cfg.n_layers * (new_tokens - 1))


def compare_paths(torch, model, params, tokens):
    """Logits through the kernels against the plain path, prefill and four
    teacher-forced decode steps: per step the max-abs error, whether it is
    inside MODEL_TOL, and the largest |logit| of the real vocab."""
    from repro_torch.models import RunKnobs
    V = model.cfg.vocab_size
    kern, plain = RunKnobs(), RunKnobs(use_kernels=False)
    lk, ck = model.prefill(params, {"tokens": tokens}, kern, cache_len=PROMPT + 8)
    lp, cp = model.prefill(params, {"tokens": tokens}, plain, cache_len=PROMPT + 8)
    steps = []
    for i in range(5):
        check(bool(torch.isfinite(lk[:, :V]).all() and torch.isfinite(lp[:, :V]).all()),
              f"{model.cfg.name}: non-finite logits")
        steps.append((max_err(lk[:, :V], lp[:, :V]), allclose(lk[:, :V], lp[:, :V], *MODEL_TOL),
                      float(lp[:, :V].abs().max())))
        if i == 4:
            break
        tok = lk.argmax(-1).to(torch.int32)[:, None]
        lk, ck = model.decode_step(params, ck, {"tokens": tok}, kern)
        lp, cp = model.decode_step(params, cp, {"tokens": tok}, plain)
    return steps


def phase_serve(torch, ops, arch):
    """Full-width ``arch`` through serve_step.generate on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import get_model
    from repro_torch.serve.serve_step import generate, make_decode, make_prefill

    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (BATCH, PROMPT), generator=gen,
                           device="cuda", dtype=torch.int32)
    batch = {"tokens": tokens}

    # the kernel path against the plain path at full width, first in float32
    # (the kernels' own arithmetic; both paths sum in f32), then in bf16
    for dtype in ("float32", cfg.dtype):
        model = get_model(cfg.with_(dtype=dtype))
        params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
        steps = compare_paths(torch, model, params, tokens)
        drift = dtype == "bfloat16" and cfg.family in ("ssm", "hybrid")
        ok = [e <= BF16_DRIFT * m if drift else w for e, w, m in steps]
        emit({"phase": "serve", "arch": arch, "dtype": dtype,
              "check": "logits through the kernels vs plain path",
              "max_abs_err": [e for e, _, _ in steps], "within_tol": [w for _, w, _ in steps],
              "max_abs_logit": [m for _, _, m in steps],
              "bound": f"max-abs <= {BF16_DRIFT} * max|logit|" if drift else list(MODEL_TOL),
              "ok": ok})
        check(all(ok), f"{arch} {dtype}: kernel-path logits differ from the plain path: {steps}")
        del params
        free(torch)

    model = get_model(cfg)
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device="cuda").manual_seed(0), "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    generate(model, params, {"tokens": tokens[:, :64]}, 2)          # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    out = generate(model, params, batch, NEW_TOKENS)
    torch.cuda.synchronize()
    generate_s = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    want = generate_launches(cfg, NEW_TOKENS)
    check(launches == want, f"{arch}: main-path launches {launches}, expected {want}")
    check(tuple(out.shape) == (BATCH, NEW_TOKENS), f"{arch}: generate shape {tuple(out.shape)}")
    check(bool(((out >= 0) & (out < cfg.vocab_size)).all()), f"{arch}: tokens outside the vocab")
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
    emit({"phase": "serve", "arch": arch, "dtype": cfg.dtype, "batch": BATCH,
          "prompt": PROMPT, "new_tokens": NEW_TOKENS, "params": model.param_count(),
          "init_s": load_s, "launches": launches, "generate_ms": generate_s * 1e3,
          "prefill_ms": sorted(pre)[1], "decode_ms_per_token": decode_ms,
          "tokens_per_s": BATCH * NEW_TOKENS / generate_s, "max_memory_allocated": peak,
          "first_tokens": out[:, :8].tolist(), "profile": [prof, prof_d]})
    del params, cache, logits
    free(torch)
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


def phase_fabric(torch, ops, arch):
    """install + WarmCache at full width: one cold request, then warm ones."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import serve_requests

    cfg = get_config(arch)
    n_req = FABRIC_REQUESTS[arch]
    ops.reset_launches()
    res = serve_requests(arch, prompt_len=PROMPT, n_tokens=FABRIC_TOKENS, batch=BATCH,
                         requests=n_req, full=True, seed=0, device="cuda")
    launches = dict(ops.LAUNCHES)
    key = f"torch/{arch}/generate/b{PROMPT}"
    # the build runs one prefill and one decode step at the bucket shape
    per_req, probe = generate_launches(cfg, FABRIC_TOKENS), generate_launches(cfg, 2)
    want = {k: probe[k] + n_req * per_req[k] for k in KERNEL_NAMES}
    emit({"phase": "fabric", "arch": arch, "key": key, "launches": launches,
          "requests": [{k: r[k] for k in ("request", "cold", "warm", "ms", "build_s")}
                       for r in res],
          "tokens": res[0]["tokens"][:2, :8].tolist()})
    check(all(r["key"] == key for r in res), f"{arch}: warmth key")
    check([r["cold"] for r in res] == [True] + [False] * (n_req - 1), f"{arch}: cold flags")
    check([r["warm"] for r in res] == [False] + [True] * (n_req - 1), f"{arch}: warm flags")
    check(launches == want, f"{arch}: fabric launches {launches}, expected {want}")
    for r in res:
        t = r["tokens"]
        check(t.shape == (BATCH, FABRIC_TOKENS) and ((t >= 0) & (t < cfg.vocab_size)).all(),
              f"{arch}: fabric tokens")
    del res
    free(torch)


def time_ms(torch, fn, sets, iters=40):
    """Device milliseconds per call: the loop is enqueued behind a sleep
    kernel, so the events time the device running the calls back to back,
    not the host launching them (a plain version that launches more than
    the sleep covers is timed partly on the host's clock). Inputs cycle
    over ``sets``, which together exceed the 50 MB L2, as the layers of a
    model do."""
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
    from repro_torch.models.ssm import ssd_scan
    gen = torch.Generator(device="cuda").manual_seed(11)
    dtype, tname = torch.bfloat16, "bfloat16"
    rows = []

    def sdpa(q, k, v):
        return F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), is_causal=True,
            enable_gqa=k.shape[2] != q.shape[2])

    for arch, idx, n_sets in ((QWEN, FLASH_QWEN, 5), (RGEMMA, FLASH_RG, 4)):
        case = FLASH_CASES[idx]                 # causal; recurrentgemma's window 2048 > S
        B, Sq, Sk, H, KVH, D = case[:6]
        sets = [flash_inputs(torch, gen, case, dtype) for _ in range(n_sets)]
        ms = time_ms(torch, lambda q, k, v: ops.flash_attention(q, k, v, window=case[7]), sets)
        plain = time_ms(torch, lambda q, k, v: ref.flash_attention(q, k, v, window=case[7]),
                        sets)
        lib = time_ms(torch, sdpa, sets)
        nbytes = 2 * (2 * B * Sq * H * D + 2 * B * Sk * KVH * D)      # q, k, v in; o out
        pairs = B * H * Sq * (Sq + 1) // 2                             # causal (q, k) pairs
        rows.append(_row("flash_attention", "src/repro/kernels/flash_attention.py:141",
                         launches[arch], errs[("flash_attention", tname, idx)], ms, plain, lib,
                         nbytes, 4 * D * pairs, tname,
                         {"arch": arch, "shape": list(case[:6]), "dtype": tname,
                          "causal": True, "window": case[7]}))

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
                     launches[QWEN], errs[("decode_attention", tname, len(DECODE_CASES) - 1)],
                     ms, plain, lib, nbytes, 4 * D * H * live, tname,
                     {"arch": QWEN, "shape": list(case[:5]), "dtype": tname,
                      "lengths": case[6]}))
    del sets, masked
    free(torch)

    case = SSD_CASES[-1]
    B, S, H, P, N, Q = case
    sets = [ssd_inputs(torch, gen, case, dtype) for _ in range(5)]     # 5 x 17.8 MB
    ms = time_ms(torch, lambda x, a, b, c: ops.ssd(x, a, b, c, chunk=Q), sets)
    plain = time_ms(torch, lambda x, a, b, c: ref.ssd(x, a, b, c), sets, iters=5)
    chunked = time_ms(torch, lambda x, a, b, c: ssd_scan(x, a, b, c, chunk=Q), sets, iters=10)
    # x, a, B and C (one group: read once), y out; the f32 state out
    nbytes = 2 * B * S * H * P + 4 * B * S * H + 2 * 2 * B * S * N + 2 * B * S * H * P \
        + 4 * B * H * P * N
    pairs = S // Q * Q * (Q + 1) // 2 + (S % Q) * (S % Q + 1) // 2     # causal pairs in chunks
    flops = 2 * B * H * (pairs * (N + P) + 2 * S * P * N)
    rows.append(_row("ssd_scan", "src/repro/kernels/ssd_scan.py:97", launches[MAMBA],
                     errs[("ssd_scan", tname, len(SSD_CASES) - 1)], ms, plain, None, nbytes,
                     flops, tname,
                     {"arch": MAMBA, "shape": list(case), "dtype": tname,
                      "b_c": "one group, head stride 0",
                      "chunked_scan_ms": chunked,
                      "chunked_scan_is": "models/ssm.py::ssd_scan, einsum/cuBLAS calls, "
                                         "not a kernel"}))
    del sets
    free(torch)

    case = RGLRU_CASES[-1]
    B, S, W = case
    sets = [rglru_inputs(torch, gen, case, torch.float32) for _ in range(3)]   # 3 x 67 MB
    ms = time_ms(torch, lambda a, b: ops.rglru(a, b), sets)
    plain = time_ms(torch, lambda a, b: ref.rglru(a, b), sets, iters=5)
    rows.append(_row("rglru_scan", "src/repro/kernels/rglru_scan.py:64", launches[RGEMMA],
                     errs[("rglru_scan", "float32", len(RGLRU_CASES) - 1)], ms, plain, None,
                     3 * 4 * B * S * W, 2 * B * S * W, "float32",
                     {"arch": RGEMMA, "shape": list(case), "dtype": "float32"}))
    del sets
    free(torch)
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
    launches = {}
    for arch in (QWEN, MAMBA, RGEMMA):
        launches[arch] = phase_serve(torch, ops, arch)
        phase_fabric(torch, ops, arch)
    rows = phase_timings(torch, ops, ref, launches, errs)
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms", "arch")
    print(smi)
    emit({"kernels": [{k: r[k] for k in keys} for r in rows]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
