"""Exact semi-join membership (the SIP probe).

Mirrors ``semijoin_probe`` of ``src/repro/kernels/sip_probe.py``: keys
``(nb, B)`` and the build side ``(S,)``, both cast to int32, give a bool
``(nb, B)``: is each key among the build keys?  ``S`` is at most 4096
(``MAX_BUILD``); a caller cuts a larger build side into chunks and ORs
the results.  The reference wrapper pads the build side with -1 to a
multiple of 128, and the padding is part of the contract: a probe key of
-1 is a member whenever ``S % 128 != 0``.  The plain version pads as the
reference does; the kernel takes the unpadded side and that rule as a
flag.

* ``semijoin_probe``       -- the wrapper: the CUDA kernel
  (csrc/semijoin_probe.cu) for CUDA tensors, the plain version for CPU
  tensors.
* ``semijoin_probe_plain`` -- the same function in plain PyTorch: the
  broadcast compare of the reference, over chunks of block rows so that
  no ``(nb, B, S)`` tensor is made at full size.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

MAX_BUILD = 4096    # keys; the reference's VMEM bound
_LANES = 128        # the reference pads the build side to this multiple
_CHUNK = 1 << 24    # compares per step of the plain version

launches = 0    # kernel launches by ``semijoin_probe``

# semijoin_probe_launch(keys, n_keys, build, n_build, minus_one_member,
#                       out, stream)
_ARGTYPES = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def minus_one_member(n_build: int) -> bool:
    """Whether the reference's padding makes a probe key of -1 a member of
    a build side of ``n_build`` keys: it pads with -1 whenever
    ``n_build % 128 != 0`` (the kernel's flag)."""
    return n_build % _LANES != 0


def _padded(build_keys: torch.Tensor) -> torch.Tensor:
    """The build side as the reference's kernel sees it: int32, padded
    with -1 to a multiple of 128."""
    b = build_keys.to(torch.int32).reshape(-1)
    pad = (-b.shape[0]) % _LANES
    if pad:
        b = torch.cat([b, b.new_full((pad,), -1)])
    return b.contiguous()


def semijoin_probe_plain(keys: torch.Tensor,
                         build_keys: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    k = keys.to(torch.int32)
    b = _padded(build_keys)
    nb, B = k.shape
    rows = max(1, _CHUNK // max(1, B * b.shape[0]))
    out = torch.empty((nb, B), dtype=torch.bool, device=k.device)
    for r in range(0, nb, rows):
        out[r:r + rows] = (k[r:r + rows, :, None] == b).any(dim=2)
    return out


def _launch(keys, build_keys):
    """The kernel on CUDA tensors: the unpadded build side, and whether
    the reference's -1 padding would make -1 a member.  A cast only where
    the dtype differs and one device check, as in ``hash_groupby``."""
    global launches
    k = keys if keys.dtype == torch.int32 else keys.to(torch.int32)
    b = build_keys if build_keys.dtype == torch.int32 \
        else build_keys.to(torch.int32)
    k = k.contiguous()
    b = (b if b.dim() == 1 else b.reshape(-1)).contiguous()
    dev = k.device
    if b.device != dev:
        raise ValueError(f"semijoin_probe: tensors on {b.device} and {dev}")
    out = torch.empty(k.shape, dtype=torch.bool, device=dev)
    if k.numel():
        fn = build.entry("semijoin_probe", "semijoin_probe_launch",
                         _ARGTYPES)
        build.check(fn(k.data_ptr(), k.numel(), b.data_ptr(), b.shape[0],
                       int(minus_one_member(b.shape[0])), out.data_ptr(),
                       build.stream_ptr(dev)),
                    "semijoin_probe")
        launches += 1
    return out


def semijoin_probe(keys: torch.Tensor,
                   build_keys: torch.Tensor) -> torch.Tensor:
    """keys ``(nb, B)``, build ``(S,)`` with ``S <= 4096`` -> bool
    ``(nb, B)``.  A CUDA tensor launches the kernel (or raises); a CPU
    tensor takes the plain version."""
    if keys.dim() != 2:
        raise ValueError(f"semijoin_probe: keys {tuple(keys.shape)} are "
                         f"not (nb, B)")
    if build_keys.numel() > MAX_BUILD:
        raise ValueError(f"semijoin_probe: {build_keys.numel()} build keys, "
                         f"at most {MAX_BUILD}; chunk the build side "
                         f"upstream")
    if keys.is_cuda:
        with torch.cuda.device(keys.device):
            return _launch(keys, build_keys)
    return semijoin_probe_plain(keys, build_keys)
