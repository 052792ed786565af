from .synth import star_schema

__all__ = ["star_schema"]
