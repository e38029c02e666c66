"""The port's container cache (``repro_torch.core.warming``) against the
reference's (``repro.core.warming``): the same requests give the same cold
starts, warm hits, evictions, teardowns and reaps."""
import pytest

from repro.core import warming as J
from repro_torch.core import warming as T

REQUESTS = ["a", "b", "a", "c", "a", "b", "b", "c"]


def _cache(mod, slots, idle_timeout=None):
    torn = []
    registry = mod.ContainerRegistry()
    registry.register_factory("k/", lambda ct: mod.ContainerSpec(
        ct, build=lambda: {"type": ct}, teardown=lambda env: torn.append(env["type"])))
    return mod.WarmCache(registry, slots=slots, idle_timeout=idle_timeout), torn


@pytest.mark.parametrize("slots", [1, 2, 3])
def test_lru_matches_reference(slots):
    def run(mod):
        cache, torn = _cache(mod, slots)
        cold = [cache.get_or_build("k/" + r)[1] for r in REQUESTS]
        s = cache.stats
        return cold, torn, (s.cold_starts, s.warm_hits, s.evictions)
    assert run(T) == run(J)


def test_reap_matches_reference():
    def run(mod):
        cache, torn = _cache(mod, slots=2, idle_timeout=5.0)
        old, _ = cache.get_or_build("k/a")
        old.last_used -= 10.0                       # idle past the timeout
        cache.get_or_build("k/b")
        reaped = cache.reap()
        return reaped, torn, cache.get_or_build("k/a")[1], cache.get_or_build("k/b")[1]
    assert run(T) == run(J) == (1, ["k/a"], True, False)


def test_no_idle_timeout_reaps_nothing():
    cache, _ = _cache(T, slots=1)
    c, _ = cache.get_or_build("k/a")
    c.last_used -= 1e6
    assert cache.reap() == 0 and cache.get_or_build("k/a")[1] is False
