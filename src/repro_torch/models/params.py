"""Parameter declaration / init system.

Single source of truth per model: a nested dict of ``ParamDecl`` (shape +
logical axis names + init), from which the concrete parameters
(``init_params``) and their count (``count_params``) are derived, so
weights and declarations can never drift apart.

Mirrors ``src/repro/models/params.py``.  ``ParamDecl``, ``_map_decls``,
``_fan_in`` and ``count_params`` are verbatim; ``init_params`` draws each
leaf from its own ``torch.Generator`` seeded from the run's seed and
``zlib_crc(path)``, as the reference folds its key per path, so adding or
removing a parameter does not reshuffle the others.  The two packages'
generators give different numbers from one seed: tests that compare them
carry the reference's weights across (models/carry.py).  The abstract
trees and partition specs of the dry-run wait for its slice.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ParamDecl:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]  # logical axis name per dim (None = none)
    init: str = "normal"             # normal | zeros | ones | embed
    scale: Optional[float] = None    # stddev override for "normal"

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


Decls = Dict[str, Any]  # nested dict: str -> ParamDecl | Decls


def _fan_in(shape: Tuple[int, ...]) -> int:
    # all dims except the last are treated as fan-in (weights are stored
    # (in_dims..., out_dims...) with out = last dim by convention here; for
    # multi-dim outputs the stddev difference is negligible for smoke tests)
    return max(1, int(np.prod(shape[:-1])))


def resolve_device(device, what: str) -> torch.device:
    """``device`` as a ``torch.device`` with its index (``cuda`` is the
    current card); CUDA without a GPU is an error, never a silent fall
    back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"{what}(device={str(device)!r}): no CUDA "
                               f"device is available; pass device='cpu' "
                               f"to run on the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _init_one(decl: ParamDecl, gen: torch.Generator, dtype,
              device) -> torch.Tensor:
    if decl.init == "zeros":
        return torch.zeros(decl.shape, dtype=dtype, device=device)
    if decl.init == "ones":
        return torch.ones(decl.shape, dtype=dtype, device=device)
    if decl.init == "embed":
        std = decl.scale if decl.scale is not None else 0.02
    else:
        std = decl.scale if decl.scale is not None \
            else _fan_in(decl.shape) ** -0.5
    x = torch.randn(decl.shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def _map_decls(decls: Decls, fn: Callable[[str, ParamDecl], Any],
               prefix: str = "") -> Dict[str, Any]:
    out = {}
    for name, d in decls.items():
        path = f"{prefix}/{name}" if prefix else name
        if isinstance(d, ParamDecl):
            out[name] = fn(path, d)
        else:
            out[name] = _map_decls(d, fn, path)
    return out


def init_params(decls: Decls, seed: int = 0, dtype=torch.float32,
                device="cuda"):
    """Materialize parameters on ``device`` (CUDA unless the caller asks
    for the CPU).  Each leaf is drawn in f32 from a generator seeded with
    ``(seed, zlib_crc(path))`` and cast to ``dtype`` once."""
    dev = resolve_device(device, "init_params")

    def one(path: str, d: ParamDecl):
        gen = torch.Generator(device=dev)
        gen.manual_seed((int(seed) << 31) | zlib_crc(path))
        return _init_one(d, gen, dtype, dev)

    return _map_decls(decls, one)


def zlib_crc(s: str) -> int:
    return zlib.crc32(s.encode()) & 0x7FFFFFFF


def count_params(decls: Decls) -> int:
    total = 0

    def one(_, d: ParamDecl):
        nonlocal total
        total += int(np.prod(d.shape))

    _map_decls(decls, one)
    return total
