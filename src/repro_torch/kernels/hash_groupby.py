"""Per-block dense GROUP BY partials (the prepass table).

Mirrors ``onehot_groupby`` of ``src/repro/kernels/hash_groupby.py``: keys
``(nb, B)`` (cast to int32) and values ``(nb, B)`` (cast to f32) give, per
block row, the count and the sum of the values of each key in
``[0, domain)``, as ``(nb, domain, 2)`` f32.  A key outside the domain
drops out (its one-hot row is zero in the reference); it is not clipped
into a group, unlike ``seg_preagg``.  The domain is capped at 1024, the
reference's bound: a caller combines larger tables upstream.

* ``onehot_groupby``       -- the wrapper: the CUDA kernel
  (csrc/onehot_groupby.cu) for CUDA tensors, the plain version for CPU
  tensors.
* ``onehot_groupby_plain`` -- the same function in plain PyTorch.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_DOMAIN = 1024

launches = 0    # kernel launches by ``onehot_groupby``

# onehot_groupby_launch(keys, values, values_float, n_blocks, n_cols,
#                       domain, out, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def onehot_groupby_plain(keys: torch.Tensor, values: torch.Tensor, *,
                         domain: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: a scatter into a
    flat ``(nb * domain)`` table at ``row * domain + key``, with the
    out-of-domain rows at weight zero."""
    nb, B = keys.shape
    k = keys.to(torch.int32).to(torch.int64)
    ok = (k >= 0) & (k < domain)
    idx = (torch.arange(nb, device=k.device)[:, None] * domain
           + torch.where(ok, k, 0)).reshape(-1)
    okf = ok.to(torch.float32).reshape(-1)
    v = torch.where(ok, values.to(torch.float32), 0.0).reshape(-1)
    cnt = torch.zeros(nb * domain, dtype=torch.float32, device=k.device) \
        .index_add_(0, idx, okf)
    s = torch.zeros(nb * domain, dtype=torch.float32, device=k.device) \
        .index_add_(0, idx, v)
    return torch.stack([cnt, s], dim=1).reshape(nb, domain, 2)


def _launch(keys, values, domain: int):
    global launches
    k = keys.to(torch.int32).contiguous()
    v, v_float = build.int32_or_f32(values)
    build.require_cuda("onehot_groupby", k, v)
    nb, B = k.shape
    out = torch.empty((nb, domain, 2), dtype=torch.float32, device=k.device)
    if nb:
        fn = build.entry("onehot_groupby", "onehot_groupby_launch",
                         _ARGTYPES)
        build.check(fn(k.data_ptr(), v.data_ptr(), v_float, nb, B, domain,
                       out.data_ptr(), build.stream_ptr(k.device)),
                    "onehot_groupby")
        launches += 1
    return out


def onehot_groupby(keys: torch.Tensor, values: torch.Tensor, *,
                   domain: int) -> torch.Tensor:
    """keys, values ``(nb, B)`` -> per-block partials ``(nb, domain, 2)``
    f32, count then sum.  A CUDA tensor launches the kernel (or raises); a
    CPU tensor takes the plain version."""
    domain = int(domain)
    if not 1 <= domain <= MAX_DOMAIN:
        raise ValueError(f"onehot_groupby: domain {domain} outside "
                         f"1..{MAX_DOMAIN}; combine larger tables upstream")
    if keys.dim() != 2 or values.shape != keys.shape:
        raise ValueError(f"onehot_groupby: keys {tuple(keys.shape)} and "
                         f"values {tuple(values.shape)} must be one (nb, B)")
    if keys.is_cuda:
        return _launch(keys, values, domain)
    return onehot_groupby_plain(keys, values, domain=domain)
