from .api import Model, get_model
from .knobs import DEFAULT_KNOBS, RunKnobs

__all__ = ["Model", "RunKnobs", "DEFAULT_KNOBS", "get_model"]
