"""Serving driver for the port: answer generation requests the way a funcX
worker does.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen1.5-0.5b \
        --prompt-len 512 --tokens 16 --batch 4 --requests 4

``--arch`` takes the served families: the dense decoders, ``mamba2-370m``
and ``recurrentgemma-9b``.

The request's container type is the warmth key
``torch/<arch>/generate/b<bucket>``. The worker gets or builds that
environment through a :class:`WarmCache` — the first request pays the cold
start (weights onto the card, kernels built, one run at the bucket shape) —
and calls ``serve_generate(data, env)``; later requests find it warm. It
runs on the card unless ``--device cpu`` is given, at full width unless
``--reduced`` is given.

Serving through a port of ``FuncXService`` (endpoints, managers, the wire)
needs the port of ``repro.core``, a later slice (ROADMAP Queue A item 6).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import numpy as np

from ..configs import ARCH_IDS, get_config, get_reduced_config
from ..core.warming import ContainerRegistry, WarmCache
from ..serve.fabric import install, serve_generate, shape_bucket, torch_key


def serve_requests(arch: str, *, prompt_len: int, n_tokens: int, batch: int,
                   requests: int, full: bool = True, seed: int = 0,
                   device=None) -> List[Dict]:
    """Send ``requests`` random prompts of ``(batch, prompt_len)`` tokens to
    one worker's warm cache. Returns, per request, whether it found the
    container cold, the ``warm`` flag the function reported, its wall
    milliseconds (build included when cold), the build seconds and the
    generated tokens."""
    cfg = get_config(arch) if full else get_reduced_config(arch)
    registry = install(ContainerRegistry(), cfg=cfg, seed=seed, device=device)
    cache = WarmCache(registry)
    key = torch_key(arch, "generate", shape_bucket(prompt_len))
    rng = np.random.default_rng(seed)
    out = []
    for i in range(requests):
        data = {"tokens": rng.integers(0, cfg.vocab_size, (batch, prompt_len)).astype(np.int32),
                "n_tokens": n_tokens}
        t0 = time.perf_counter()
        container, cold = cache.get_or_build(key)
        res = serve_generate(data, container.env)
        out.append({"request": i, "key": key, "cold": cold, "warm": res["warm"],
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "build_s": container.build_time if cold else 0.0,
                    "tokens": res["tokens"]})
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    p.add_argument("--reduced", action="store_true",
                   help="the reduced config instead of full width")
    p.add_argument("--requests", type=int, default=4)
    p.add_argument("--prompt-len", type=int, default=16)
    p.add_argument("--tokens", type=int, default=8)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None, help="default: the card")
    args = p.parse_args()
    for r in serve_requests(args.arch, prompt_len=args.prompt_len, n_tokens=args.tokens,
                            batch=args.batch, requests=args.requests, full=not args.reduced,
                            seed=args.seed, device=args.device):
        print(f"request {r['request']}: {'cold' if r['cold'] else 'warm'} "
              f"{r['ms']:.1f} ms (build {r['build_s']:.2f} s), "
              f"tokens {r['tokens'][0][:8].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
