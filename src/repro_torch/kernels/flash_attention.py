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

Training (the port's own addition; the reference's Pallas kernel has no
backward and its model trains through ``attend``, which jax
differentiates):

* ``flash_attention_bwd``       -- dq, dk, dv from q, k, v, the forward's
  output and its gradient: a CUDA kernel (csrc/flash_attention_bwd.cu,
  two launches, no atomics, so a rerun is bit for bit the same) for CUDA
  tensors, the plain version for CPU tensors.  The wrapper hands the
  kernel contiguous copies of its five inputs (the model's permuted views
  are not), grouped as (kv heads, G, rows, d).
* ``flash_attention_bwd_plain`` -- the same recompute formulas in plain
  PyTorch.
* ``flash_attention_train``     -- a ``torch.autograd.Function``: forward
  through ``flash_attention``, backward through ``flash_attention_bwd``.
  Both are looked up in this module at call time.
"""
from __future__ import annotations

import ctypes
import math
from typing import List, Tuple

import torch

from . import build

launches = 0        # kernel launches by ``flash_attention``
bwd_launches = 0    # kernel launches by ``flash_attention_bwd`` (2 a call)

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


# ------------------------------------------------------------- backward --

# flash_attention_bwd_launch(q, k, v, o, do, dq, dk, dv, scratch, n_kv, G,
#                            S, T, D, causal, bf16, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 \
    + [ctypes.c_void_p]


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed over the dims where ``shape`` has 1 and ``t`` more:
    the gradient of a tensor that broadcast to ``t``'s shape."""
    dims = [i for i, (n, m) in enumerate(zip(t.shape, shape))
            if m == 1 and n != 1]
    return t.sum(dim=dims, keepdim=True) if dims else t


def flash_attention_bwd_plain(q, k, v, out, dout, *, causal: bool = True):
    """Plain PyTorch version of the backward kernel, on any device: the
    recompute formulas, in f32.  Scores s = q.k / sqrt(d) (masked at
    -1e30), P = exp(s - logsumexp(s)), D = rowsum(dout * out), dP = dout
    v^T, dS = P (dP - D); dq = dS k / sqrt(d), dk = dS^T q / sqrt(d), dv =
    P^T dout, dk and dv summed over the leading dims k and v broadcast
    over.  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    dof = dout.to(torch.float32)
    s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
    if causal:
        S, T = s.shape[-2:]
        mask = (torch.arange(S, device=s.device)[:, None]
                >= torch.arange(T, device=s.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    delta = (dof * out.to(torch.float32)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = _sum_to(torch.matmul(ds.transpose(-1, -2), qf) * scale, k.shape)
    dv = _sum_to(torch.matmul(p.transpose(-1, -2), dof), v.shape)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_layout(q, k, v, out, dout):
    """What the backward kernel reads: returns ((q, k, v, out, dout) as
    contiguous copies, n_kv, G, inv).  q's leading dims are reordered with
    those where k and v have their own entries first (size 1 in q counts
    as such) and those they broadcast over last, so that the copies of q,
    out and dout are (n_kv, G, S, d) in memory and those of k and v (n_kv,
    T, d).  Gradients laid out as those copies go back to the inputs'
    dim order with ``.permute(inv)``."""
    q_lead, kv_lead = tuple(q.shape[:-2]), tuple(k.shape[:-2])
    own = [i for i, (n, m) in enumerate(zip(q_lead, kv_lead)) if m == n]
    shared = [i for i, (n, m) in enumerate(zip(q_lead, kv_lead)) if m != n]
    nl = len(q_lead)
    full = own + shared + [nl, nl + 1]
    inv = [full.index(i) for i in range(nl + 2)]
    copies = tuple(t.permute(full).contiguous() for t in (q, k, v, out, dout))
    return (copies, math.prod(q_lead[i] for i in own),
            math.prod(q_lead[i] for i in shared), inv)


def _launch_bwd(q, k, v, out, dout, causal):
    global bwd_launches
    build.require_cuda("flash_attention_bwd", q, k, v, out, dout,
                       dtypes=(q.dtype,) * 5, contiguous=False)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_bwd: {q.dtype}, expected float32 "
                        f"or bfloat16")
    S, d = q.shape[-2:]
    T = k.shape[-2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d}, the kernel "
                         f"takes {HEAD_DIMS}")
    (qc, kc, vc, oc, doc), n_kv, G, inv = bwd_layout(q, k, v, out, dout)
    dq, dk, dv = (torch.empty_like(t) for t in (qc, kc, vc))
    if n_kv * G == 0 or S == 0:
        return tuple(t.zero_().permute(inv) for t in (dq, dk, dv))
    scratch = torch.empty(2 * n_kv * G * S, dtype=torch.float32,
                          device=q.device)
    fn = build.entry("flash_attention_bwd", "flash_attention_bwd_launch",
                     _BWD_ARGTYPES)
    build.check(fn(*(t.data_ptr() for t in (qc, kc, vc, oc, doc, dq, dk, dv,
                                            scratch)),
                   n_kv, G, S, T, d, int(causal),
                   int(q.dtype == torch.bfloat16),
                   build.stream_ptr(q.device)), "flash_attention_bwd")
    bwd_launches += 2
    return dq.permute(inv), dk.permute(inv), dv.permute(inv)


def flash_attention_bwd(q, k, v, out, dout, *, causal: bool = True):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal)`` for
    the output gradient ``dout``, given the forward's output ``out``: q,
    out, dout ``(..., S, d)``; k, v ``(..., T, d)``, broadcast over q's
    leading dims (dk and dv come back with k's and v's shapes, summed over
    the dims they broadcast over).  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain version."""
    if q.shape != out.shape or q.shape != dout.shape or k.shape != v.shape \
            or k.dim() != q.dim() or k.shape[-1] != q.shape[-1]:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if k.shape[-2] == 0:
        raise ValueError("flash_attention_bwd: no keys (T = 0)")
    if any(n not in (m, 1) for n, m in zip(k.shape[:-2], q.shape[:-2])):
        raise ValueError(f"flash_attention_bwd: kv leading dims "
                         f"{tuple(k.shape[:-2])} do not broadcast to "
                         f"{tuple(q.shape[:-2])}")
    if q.is_cuda:
        return _launch_bwd(q, k, v, out, dout, causal)
    return flash_attention_bwd_plain(q, k, v, out, dout, causal=causal)


class FlashAttentionFn(torch.autograd.Function):
    """Attention whose forward is ``flash_attention`` and whose backward is
    ``flash_attention_bwd``; it saves q, k, v and the output."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = flash_attention(q, k, v, causal=causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(),
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """``flash_attention`` with a gradient (the training path's
    attention)."""
    return FlashAttentionFn.apply(q, k, v, causal)
