"""Carry the reference's weights and caches across packages.

The reference's parameters and prefill caches are nested dicts of arrays;
handed over as numpy (``np.asarray`` of each leaf), ``params_from_numpy``
and ``cache_from_numpy`` build the port's trees on a device, so the two
packages compute on the same weights.  bf16 arrays (numpy's ``bfloat16``
extension type, which ``torch.from_numpy`` does not take) cross as their
16-bit patterns.

Serving holds bf16 weights (models/layers.py): casting the reference's f32
master weights to bf16 once, here, gives the same numbers as the
reference's ``.astype(bf16)`` at every use.  Both functions map nested
dicts of any depth, so an MoE block's ``{"moe": {"router", "wi_gate",
"wi_up", "wo"}}``, an SSM or hybrid block's ``{"ssm": {...}}`` beside its
``ln_ssm`` (and a hybrid's ``attn_scale`` / ``ssm_scale``), and an int8
cache entry's ``{"k": {"q", "s"}, "v": {...}}`` cross as they are; a
cache keeps each leaf's own dtype (bf16; int8 codes beside f32 scales; an
SSM entry's f32 state beside its bf16 conv rings).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch


def tensor_from_numpy(a, device, dtype=None) -> torch.Tensor:
    """One numpy array (bf16 included) as a tensor on ``device``, cast to
    ``dtype`` when given."""
    a = np.ascontiguousarray(a)
    if not a.flags.writeable:        # a jax array's numpy view
        a = a.copy()
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None:
        t = t.to(dtype)
    return t.to(device)


def _tree(tree, fn):
    if isinstance(tree, dict):
        return {k: _tree(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_numpy(tree: Dict[str, Any], device,
                      dtype=torch.bfloat16) -> Dict[str, Any]:
    """The reference's parameter tree as the port's, cast once to
    ``dtype``."""
    return _tree(tree, lambda a: tensor_from_numpy(a, device, dtype))


def cache_from_numpy(tree: Dict[str, Any], device) -> Dict[str, Any]:
    """The reference's prefill cache as the port's, each leaf in its own
    dtype (bf16, the cache type of both packages; int8 codes and f32
    scales with ``kv_quant``; an SSM entry's f32 state and bf16 conv
    rings)."""
    return _tree(tree, lambda a: tensor_from_numpy(a, device))
