"""Container management (paper §6), the port of the container-cache part
of ``repro.core.warming`` (ContainerSpec, Container, ContainerRegistry,
WarmCache), copied so that the port imports nothing of ``repro``.

A funcX *container type* maps to a serving environment: for the port's
fabric, weights resident on the card, the CUDA kernels built and loaded,
and the model run once at the bucket shape. Building it is the cold start.

``ContainerSpec.build()`` performs the cold start. ``WarmCache`` keeps
containers warm: LRU under bounded slots, and keep-warm with an idle
timeout (§6.1).
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple


@dataclass
class ContainerSpec:
    container_type: str
    build: Callable[[], Any] = lambda: None
    teardown: Callable[[Any], None] = lambda env: None


@dataclass
class Container:
    spec: ContainerSpec
    env: Any
    built_at: float
    build_time: float
    last_used: float
    uses: int = 0


class ContainerRegistry:
    """Service/endpoint-level registry of container specs (image registry).

    Beyond enumerated specs, a *spec factory* can claim a key prefix
    (``register_factory("torch/", fn)``): on a registry miss the factory
    mints the spec for that concrete type on first demand. This is how
    the serving fabric (``serve/fabric.py``) exposes the model zoo —
    every ``torch/<arch>/<step>/b<bucket>`` combination — without
    enumerating the cross product up front."""

    def __init__(self):
        self._specs: Dict[str, ContainerSpec] = {}
        self._factories: List[Tuple[str, Callable[[str], ContainerSpec]]] = []
        self._lock = threading.RLock()

    def register(self, spec: ContainerSpec) -> None:
        with self._lock:
            self._specs[spec.container_type] = spec

    def register_factory(self, prefix: str,
                         factory: Callable[[str], ContainerSpec]) -> None:
        """``factory(container_type) -> ContainerSpec`` for any type
        starting with ``prefix``. Later registrations win (prepended)."""
        with self._lock:
            self._factories.insert(0, (prefix, factory))

    def get(self, container_type: str) -> ContainerSpec:
        with self._lock:
            spec = self._specs.get(container_type)
            if spec is not None:
                return spec
            factories = list(self._factories)
        for prefix, factory in factories:
            if container_type.startswith(prefix):
                spec = factory(container_type)
                if spec is not None:
                    self.register(spec)
                    return spec
        with self._lock:
            if container_type not in self._specs:
                # bare python environment — no build cost
                self._specs[container_type] = ContainerSpec(container_type)
            return self._specs[container_type]


@dataclass
class WarmStats:
    cold_starts: int = 0
    warm_hits: int = 0
    evictions: int = 0
    build_time: float = 0.0


class WarmCache:
    """Per-worker warm-container cache: at most ``slots`` containers, the
    least recently used evicted on pressure, and, with ``idle_timeout``
    (seconds), those idle past it released by :meth:`reap` (paper §6.1).

    The reference's worker-facing hooks (``note_warm``, ``on_change``,
    ``next_reap_deadline``, the warm-set queries for heartbeats) come with
    the port of the worker and manager (ROADMAP Queue A item 6)."""

    def __init__(self, registry: ContainerRegistry, slots: int = 1,
                 idle_timeout: Optional[float] = None):
        self.registry = registry
        self.slots = slots
        self.idle_timeout = idle_timeout
        self._warm: Dict[str, Container] = {}
        self._lock = threading.RLock()
        self.stats = WarmStats()

    def get_or_build(self, container_type: str) -> Tuple[Container, bool]:
        """Returns (container, cold_start?)."""
        with self._lock:
            c = self._warm.get(container_type)
            if c is not None:
                c.last_used = time.perf_counter()
                c.uses += 1
                self.stats.warm_hits += 1
                return c, False
        # cold start — build outside the lock (it can take seconds)
        spec = self.registry.get(container_type)
        t0 = time.perf_counter()
        env = spec.build()
        build_time = time.perf_counter() - t0
        c = Container(spec, env, t0, build_time, time.perf_counter(), 1)
        with self._lock:
            while len(self._warm) >= self.slots:
                self._evict_one()
            self._warm[container_type] = c
            self.stats.cold_starts += 1
            self.stats.build_time += build_time
        return c, True

    def _release(self, key: str) -> None:
        victim = self._warm.pop(key)
        try:
            victim.spec.teardown(victim.env)
        except Exception:
            pass
        self.stats.evictions += 1

    def _evict_one(self) -> None:
        if self._warm:
            self._release(min(self._warm, key=lambda k: self._warm[k].last_used))

    def reap(self) -> int:
        """Release containers idle past the timeout (paper §6.1). Returns
        the number reaped."""
        if self.idle_timeout is None:
            return 0
        cutoff = time.perf_counter() - self.idle_timeout
        with self._lock:
            idle = [k for k, c in self._warm.items() if c.last_used < cutoff]
            for key in idle:
                self._release(key)
        return len(idle)
