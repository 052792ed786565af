"""Registry of the assigned architectures (+ the paper's own workload cfg).

Each module defines ``CONFIG: ArchConfig`` with the exact published numbers
from the assignment table. ``get(name)`` and ``all_archs()`` are the public
API; the launcher's ``--arch`` flag resolves through here.

Mirrors ``src/repro/configs/__init__.py``: a verbatim copy (jax-free
data), so the port imports nothing of the reference package.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from .base import (ALL_SHAPES, SHAPES_BY_NAME, ArchConfig, MoEConfig,
                   RunConfig, ShapeConfig, SSMConfig)

_ARCH_MODULES = {
    "olmoe-1b-7b": "olmoe_1b_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe",
    "qwen3-4b": "qwen3_4b",
    "starcoder2-7b": "starcoder2_7b",
    "granite-3-8b": "granite3_8b",
    "phi3-mini-3.8b": "phi3_mini",
    "hymba-1.5b": "hymba_1_5b",
    "mamba2-130m": "mamba2_130m",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "llama-3.2-vision-11b": "llama32_vision_11b",
}

ARCH_NAMES = tuple(_ARCH_MODULES)


def get(name: str) -> ArchConfig:
    if name.endswith("-reduced"):
        return get(name[: -len("-reduced")]).reduced()
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f".{_ARCH_MODULES[name]}", __package__)
    return mod.CONFIG


def all_archs() -> List[ArchConfig]:
    return [get(n) for n in ARCH_NAMES]


__all__ = ["ALL_SHAPES", "SHAPES_BY_NAME", "ARCH_NAMES", "ArchConfig",
           "MoEConfig", "RunConfig", "ShapeConfig", "SSMConfig", "get",
           "all_archs"]
