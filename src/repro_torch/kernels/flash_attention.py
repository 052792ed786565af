"""Blocked causal attention (flash) -- the LM stack's prefill hot spot.

Mirrors ``flash_attention`` of ``src/repro/kernels/flash_attention.py``
batched as ``src/repro/kernels/ops.py`` batches it, and computes the
contract of ``ref.flash_attention_ref``: q ``(..., S, d)`` and k, v
``(..., T, d)`` give ``softmax(q k^T / sqrt(d)) v`` with f32 scores, a
causal top-left mask (query i sees keys 0..i) at -1e30, softmax and P.V in
f32, and one cast to q's dtype at the end.

* ``flash_attention``       -- the wrapper: a CUDA kernel
  (csrc/flash_attention.cu, one launch for every leading index) for CUDA
  tensors, the plain version for CPU tensors.  bf16 runs on the tensor
  cores (wgmma, fed by TMA through the maps of ``tensor_maps``), f32 on
  scalar FMAs (tensor cores would round it to TF32).
* ``flash_attention_plain`` -- the same function in plain PyTorch.

Grouped-query attention: k and v broadcast over q's leading dims (each
is q's or 1), so q ``(B, K, G, S, d)`` goes against k ``(B, K, 1, T, d)``
and the kernel reads each kv head once for its G query heads instead of
an expanded copy.  The kernel reads q, k and v and writes its output
through their strides (the head dim contiguous), so the model passes
permuted views of its ``(B, S, heads, d)`` tensors and gets its output
back in q's memory order, with no copy on either side.  Unlike the
reference, S and T need not be multiples of a tile: the kernel masks
ragged tiles.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from . import build

launches = 0    # kernel launches by ``flash_attention``

HEAD_DIMS = (64, 96, 128)       # the kernel's instantiations
NEG_INF = -1e30

_LL = ctypes.POINTER(ctypes.c_longlong)
# flash_attention_launch(q, k, v, out, dims[3], strides[16], S, T, D,
#                        causal, stream): f32
_ARGTYPES = [ctypes.c_void_p] * 4 + [_LL, _LL] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# flash_attention_sm90_launch(q, k, v, out, dims[15], strides[12], lead[3],
#                             out_strides[4], S, T, D, causal, stream): bf16
_SM90_ARGTYPES = [ctypes.c_void_p] * 4 + [_LL] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
LEAD_DIMS = 3           # leading dims the kernel indexes, after merging
BOX_COLS = 64           # a TMA box: 64 columns (128 bytes of bf16) ...
BOX_ROWS = 128          # ... by 128 rows (the kernel's q and kv tiles)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: the reference
    oracle's arithmetic, batched by broadcasting over leading dims."""
    d = q.shape[-1]
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) / math.sqrt(d)
    if causal:
        S, T = s.shape[-2:]
        mask = (torch.arange(S, device=s.device)[:, None]
                >= torch.arange(T, device=s.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.matmul(p, v.to(torch.float32)).to(q.dtype)


def kernel_layout(q, k, v, out) -> Tuple[List[int], List[int]]:
    """The leading sizes and the element strides the kernel takes for q
    ``(..., S, d)``, k and v ``(..., T, d)`` broadcast to q's leading dims,
    and out shaped as q: ``LEAD_DIMS`` sizes, then for q, k, v and out in
    turn the strides of those dims and of the row dim (0 where k and v
    broadcast).  Size-1 dims drop out and dims that step evenly in all
    four tensors merge; raises if more than ``LEAD_DIMS`` remain, if the
    head dim is not contiguous, or if a stride is not a multiple of 16
    bytes (4 f32 or 8 bf16 elements)."""
    lead = tuple(q.shape[:-2])
    try:
        k, v = (t.expand(*lead, *t.shape[-2:]) for t in (k, v))
    except RuntimeError as e:
        raise ValueError(f"flash_attention: kv leading dims "
                         f"{tuple(k.shape[:-2])} do not broadcast to "
                         f"{lead}") from e
    ts = (q, k, v, out)
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention: the head dim is not contiguous")
    dims = []                        # (size, [stride in q, k, v, out])
    for i, n in enumerate(lead):
        if n == 1:
            continue
        st = [t.stride(i) for t in ts]
        if dims and all(a == b * n for a, b in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > LEAD_DIMS:
        raise ValueError(f"flash_attention: leading dims {lead} with "
                         f"these strides need {len(dims)} indices, the "
                         f"kernel takes {LEAD_DIMS}")
    dims = [(1, [0] * 4)] * (LEAD_DIMS - len(dims)) + dims
    strides = [st[j] for j in range(4) for st in
               [d[1] for d in dims] + [[t.stride(-2) for t in ts]]]
    per = 16 // q.element_size()
    if any(x % per for x in strides):
        raise ValueError(f"flash_attention: strides {strides} are not all "
                         f"multiples of {per} elements")
    return [d[0] for d in dims], strides


def tensor_maps(q, k, v, out):
    """What the bf16 kernel's TMA maps describe: returns (lead, dims,
    strides, out_strides).  ``lead`` and the element strides come from
    ``kernel_layout``.  Per map of q, k and v in turn, ``dims`` holds 5
    sizes (d, rows, leading dims 2, 1, 0) and ``strides`` the byte strides
    of its 4 outer dims.  A leading dim where the tensor has stride 0 (k
    and v broadcast over the group) has size 1 there, so the kernel gives
    it coordinate 0; the hardware takes no stride 0.  A
    dim of size 1 gets a stride past everything before it, since the
    hardware reads no stride there.  ``out_strides``: out's element
    strides of leading dims 0-2 and rows, the kernel's stores."""
    lead, strides = kernel_layout(q, k, v, out)
    S, d = q.shape[-2:]
    T = k.shape[-2]
    size = q.element_size()
    dims, bstrides = [], []
    for j, rows in enumerate((S, T, T)):
        st = strides[4 * j:4 * j + 4]
        outer = [(rows, st[3])] + [(n if x else 1, x)
                                   for n, x in zip(lead[::-1], st[2::-1])]
        dims += [d] + [n for n, _ in outer]
        span = d * size                  # bytes up to the current dim
        for n, x in outer:
            if n > 1 and x == 0:
                raise ValueError(f"flash_attention: stride 0 over {n} rows")
            b = x * size if n > 1 else span
            bstrides.append(b)
            span = max(span, b * n)
    return lead, dims, bstrides, strides[12:]


def _launch(q, k, v, causal):
    global launches
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention: {q.dtype}, expected float32 or "
                        f"bfloat16")
    build.require_cuda("flash_attention", q, k, v,
                       dtypes=(q.dtype, q.dtype, q.dtype), contiguous=False)
    S, d = q.shape[-2:]
    T = k.shape[-2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d}, the kernel takes "
                         f"{HEAD_DIMS}")
    out = torch.empty_like(q)        # q's memory order where q is dense
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: a tensor is not 16-byte aligned")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    arr = lambda xs: (ctypes.c_longlong * len(xs))(*xs)
    if q.dtype == torch.bfloat16:
        lead, dims, strides, out_strides = tensor_maps(q, k, v, out)
        if math.prod(lead) and S:
            fn = build.entry("flash_attention", "flash_attention_sm90_launch",
                             _SM90_ARGTYPES)
            build.check(fn(*ptrs, arr(dims), arr(strides), arr(lead),
                           arr(out_strides), S, T, d, int(causal),
                           build.stream_ptr(q.device)), "flash_attention")
            launches += 1
        return out
    lead, strides = kernel_layout(q, k, v, out)
    if math.prod(lead) and S:
        fn = build.entry("flash_attention", "flash_attention_launch",
                         _ARGTYPES)
        build.check(fn(*ptrs, arr(lead), arr(strides), S, T, d, int(causal),
                       build.stream_ptr(q.device)), "flash_attention")
        launches += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128,
                    bk: int = 128) -> torch.Tensor:
    """q ``(..., S, d)``, k/v ``(..., T, d)`` -> ``(..., S, d)`` in q's
    dtype.  A CUDA tensor launches the kernel (or raises); a CPU tensor
    takes the plain version.  ``bq`` and ``bk`` are the reference's tile
    sizes, kept for its signature: the Hopper kernels' tiles are fixed by
    their design (bf16: 128 queries by 128 keys; f32: 64 by 32), and the
    result does not depend on them."""
    if q.dim() < 2 or k.shape != v.shape or k.dim() != q.dim() \
            or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         f"(..., S, d) and (..., T, d)")
    if k.shape[-2] == 0:
        raise ValueError("flash_attention: no keys (T = 0)")
    lead = tuple(q.shape[:-2])
    if any(n not in (m, 1) for n, m in zip(k.shape[:-2], lead)):
        raise ValueError(f"flash_attention: kv leading dims "
                         f"{tuple(k.shape[:-2])} do not broadcast to {lead}")
    if bq <= 0 or bk <= 0:
        raise ValueError(f"flash_attention: tiles bq={bq}, bk={bk}")
    if q.is_cuda:
        return _launch(q, k, v, causal)
    return flash_attention_plain(q, k, v, causal=causal)
