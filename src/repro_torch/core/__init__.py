"""The port's copy of the funcX container cache. The rest of ``repro.core``
(service, endpoint, workers, wire protocol) is a later slice (ROADMAP
Queue A item 6)."""
from .warming import Container, ContainerRegistry, ContainerSpec, WarmCache, WarmStats

__all__ = ["Container", "ContainerRegistry", "ContainerSpec", "WarmCache", "WarmStats"]
