"""The LM stack of the port (dense decoder-only family so far): parameter
declarations, layers, attention, the decoder and ``build_model``.
Mirrors ``src/repro/models/``."""
from .model import Model, build_model
from .params import count_params, init_params

__all__ = ["Model", "build_model", "count_params", "init_params"]
