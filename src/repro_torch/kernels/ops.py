"""Public kernel entry points of the port, and their launch counts.

Mirrors ``src/repro/kernels/ops.py``.  Dispatch is by the device of the
tensors a caller hands over, never by a flag: a CUDA tensor launches the
hand-written Hopper kernel (built from ``csrc/`` at first use, see
kernels/build.py) or raises, a CPU tensor takes the kernel's plain
PyTorch version.  Each wrapper counts its kernel launches, so a run can
show that the main path went through the kernels.

Ported so far: ``bitunpack``, ``seg_preagg`` (the engine's dense GROUP BY)
and ``rle_grouped_agg``.  ``rle_filter_agg``, ``onehot_groupby``,
``semijoin_probe``, ``delta_decode`` and ``flash_attention`` are not.
"""
from __future__ import annotations

from typing import Dict

from . import bitunpack as _bitunpack_mod
from . import rle_scan_agg as _rle_mod
from . import seg_preagg as _seg_mod
from .bitunpack import bitunpack, bitunpack_plain
from .rle_scan_agg import rle_grouped_agg, rle_grouped_agg_plain
from .seg_preagg import seg_preagg, seg_preagg_plain

_COUNTED = {"bitunpack": _bitunpack_mod, "seg_preagg": _seg_mod,
            "rle_grouped_agg": _rle_mod}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: mod.launches for name, mod in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod in _COUNTED.values():
        mod.launches = 0


__all__ = ["bitunpack", "bitunpack_plain", "launch_counts",
           "reset_launch_counts", "rle_grouped_agg", "rle_grouped_agg_plain",
           "seg_preagg", "seg_preagg_plain"]
