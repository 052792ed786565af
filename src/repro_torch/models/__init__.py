"""The LM stack of the port (every family: dense, MoE, SSM, hybrid,
enc-dec and VLM): parameter declarations, layers, attention, the
decoder and ``build_model``.
Mirrors ``src/repro/models/``."""
from .model import Model, build_model
from .params import count_params, init_params

__all__ = ["Model", "build_model", "count_params", "init_params"]
