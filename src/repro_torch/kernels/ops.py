"""Public kernel entry points of the port, and their launch counts.

Mirrors ``src/repro/kernels/ops.py``.  Dispatch is by the device of the
tensors a caller hands over, never by a flag: a CUDA tensor launches the
hand-written Hopper kernel (built from ``csrc/`` at first use, see
kernels/build.py) or raises, a CPU tensor takes the kernel's plain
PyTorch version.  Each wrapper counts its kernel launches, so a run can
show that a path went through the kernels.

Ported: ``bitunpack`` (one word stream; ``bitunpack_segments`` unpacks
the kept blocks of a list of streams in one launch and counts under
``bitunpack``; ``gather_unpack`` is torch indexing, as the reference's is
jnp), ``seg_preagg`` (the engine's dense GROUP BY), ``rle_grouped_agg``
-- the three the query path runs -- and
``rle_filter_agg`` (``rle_filter_agg_many`` takes a list of run segments
in one launch and counts under ``rle_filter_agg``), ``onehot_groupby``, ``semijoin_probe`` and
``delta_decode``, which only this entry point reaches, as in the
reference, and ``flash_attention``, which the port's LM prefill calls
here for its causal self-attention (models/transformer.py).
``flash_attention_bwd`` is the port's own kernel, the gradient of that
forward, with no Pallas counterpart; ``flash_attention_train``, the
autograd function over the two, is what the training path calls.
"""
from __future__ import annotations

from typing import Dict

from . import bitunpack as _bitunpack_mod
from . import delta_decode as _delta_mod
from . import flash_attention as _flash_mod
from . import hash_groupby as _groupby_mod
from . import rle_scan_agg as _rle_mod
from . import seg_preagg as _seg_mod
from . import sip_probe as _sip_mod
from .bitunpack import (Segment, bitunpack, bitunpack_plain,
                        bitunpack_segments, bitunpack_segments_plain,
                        gather_unpack)
from .delta_decode import delta_decode, delta_decode_plain
from .flash_attention import (flash_attention, flash_attention_bwd,
                              flash_attention_bwd_plain,
                              flash_attention_plain, flash_attention_train)
from .hash_groupby import onehot_groupby, onehot_groupby_plain
from .rle_scan_agg import (rle_filter_agg, rle_filter_agg_many,
                           rle_filter_agg_many_plain, rle_filter_agg_plain,
                           rle_grouped_agg, rle_grouped_agg_many,
                           rle_grouped_agg_many_plain, rle_grouped_agg_plain)
from .seg_preagg import seg_preagg, seg_preagg_plain, seg_preagg_route
from .sip_probe import semijoin_probe, semijoin_probe_plain

# kernel name -> (wrapper module, its launch counter)
_COUNTED = {"bitunpack": (_bitunpack_mod, "launches"),
            "seg_preagg": (_seg_mod, "launches"),
            "rle_grouped_agg": (_rle_mod, "grouped_launches"),
            "rle_filter_agg": (_rle_mod, "filter_launches"),
            "onehot_groupby": (_groupby_mod, "launches"),
            "semijoin_probe": (_sip_mod, "launches"),
            "delta_decode": (_delta_mod, "launches"),
            "flash_attention": (_flash_mod, "launches"),
            "flash_attention_bwd": (_flash_mod, "bwd_launches")}


def launch_counts() -> Dict[str, int]:
    """Kernel launches per wrapper since the last reset."""
    return {name: getattr(mod, attr)
            for name, (mod, attr) in _COUNTED.items()}


def reset_launch_counts() -> None:
    for mod, attr in _COUNTED.values():
        setattr(mod, attr, 0)


__all__ = ["Segment", "bitunpack", "bitunpack_plain",
           "bitunpack_segments", "bitunpack_segments_plain", "delta_decode",
           "delta_decode_plain", "flash_attention", "flash_attention_bwd",
           "flash_attention_bwd_plain", "flash_attention_plain",
           "flash_attention_train",
           "gather_unpack", "launch_counts", "onehot_groupby",
           "onehot_groupby_plain", "reset_launch_counts", "rle_filter_agg",
           "rle_filter_agg_many", "rle_filter_agg_many_plain",
           "rle_filter_agg_plain", "rle_grouped_agg", "rle_grouped_agg_many",
           "rle_grouped_agg_many_plain", "rle_grouped_agg_plain",
           "seg_preagg", "seg_preagg_plain", "seg_preagg_route",
           "semijoin_probe", "semijoin_probe_plain"]
