"""The LM stack of the port (every family: dense, MoE, SSM, hybrid,
enc-dec and VLM): parameter declarations, layers, attention, the
decoder and ``build_model``.
Mirrors ``src/repro/models/``."""
from .model import Model, build_model, cache_partition_axes
from .params import abstract_params, count_params, init_params

__all__ = ["Model", "abstract_params", "build_model",
           "cache_partition_axes", "count_params", "init_params"]
