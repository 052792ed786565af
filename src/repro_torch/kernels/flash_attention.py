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

With ``return_lse=True`` both also return each row's logsumexp of its
scaled, masked scores (f32, q's shape without the head dim): the
kernels store it from the registers that hold the row's max and sum, for
the backward.

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
  output, its lse and the output's gradient: a CUDA kernel
  (csrc/flash_attention_bwd.cu, two launches, no atomics, so a rerun is
  bit for bit the same) for CUDA tensors, the plain version for CPU
  tensors.  bf16 runs on the tensor cores, reading all five inputs
  through TMA maps of their own strides (``bwd_layout``), f32 on scalar
  FMAs through the same strides; neither copies an input, and dq, dk, dv
  come back in q's, k's and v's memory order.
* ``flash_attention_bwd_plain`` -- the same formulas in plain PyTorch.
* ``flash_attention_train``     -- a ``torch.autograd.Function``: forward
  through ``flash_attention`` (saving its lse), backward through
  ``flash_attention_bwd``.  Both are looked up in this module at call
  time.
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


def _arr(xs):
    return (ctypes.c_longlong * len(xs))(*xs)


# flash_attention_launch(q, k, v, out, lse, dims[3], strides[16], S, T, D,
#                        causal, stream): f32
_ARGTYPES = [ctypes.c_void_p] * 5 + [_LL, _LL] + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# flash_attention_sm90_launch(q, k, v, out, lse, dims[15], strides[12],
#                             lead[3], out_strides[4], S, T, D, causal,
#                             stream): bf16
_SM90_ARGTYPES = [ctypes.c_void_p] * 5 + [_LL] * 4 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
LEAD_DIMS = 3           # leading dims the kernel indexes, after merging
BOX_COLS = 64           # a TMA box: 64 columns (128 bytes of bf16) ...
BOX_ROWS = 128          # ... by 128 rows (the kernel's q and kv tiles)
LSE_ROWS = 64           # the backward's lse and D scratch: rows rounded up


def _masked_scores(q, k, causal: bool) -> torch.Tensor:
    """f32 scores q.k / sqrt(d), causal keys past the row at -1e30."""
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) \
        / math.sqrt(q.shape[-1])
    if causal:
        S, T = s.shape[-2:]
        mask = (torch.arange(S, device=s.device)[:, None]
                >= torch.arange(T, device=s.device)[None, :])
        s = torch.where(mask, s, NEG_INF)
    return s


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, return_lse: bool = False):
    """Plain PyTorch version of the kernel, on any device: the reference
    oracle's arithmetic, batched by broadcasting over leading dims.  With
    ``return_lse``, also ``torch.logsumexp`` of the masked f32 scores."""
    s = _masked_scores(q, k, causal)
    out = torch.matmul(torch.softmax(s, dim=-1),
                       v.to(torch.float32)).to(q.dtype)
    return (out, torch.logsumexp(s, dim=-1)) if return_lse else out


def kernel_layout(q, *others) -> Tuple[List[int], List[int]]:
    """The leading sizes and the element strides the kernels take for q
    ``(..., S, d)`` and ``others`` (the forward: k, v, out; the backward:
    k, v, out, dout, dq, dk, dv), each broadcast to q's leading dims:
    ``LEAD_DIMS`` sizes, then for every tensor in turn the strides of
    those dims and of the row dim (0 where k and v broadcast).  Size-1
    dims drop out and dims that step evenly in all tensors merge; raises
    if more than ``LEAD_DIMS`` remain, if the head dim is not contiguous,
    or if a stride is not a multiple of 16 bytes (4 f32 or 8 bf16
    elements)."""
    lead = tuple(q.shape[:-2])
    try:
        others = [t.expand(*lead, *t.shape[-2:]) for t in others]
    except RuntimeError as e:
        raise ValueError(f"flash_attention: kv leading dims "
                         f"{tuple(others[0].shape[:-2])} do not broadcast "
                         f"to {lead}") from e
    ts = (q, *others)
    if any(t.stride(-1) != 1 for t in ts):
        raise ValueError("flash_attention: the head dim is not contiguous")
    dims = []                        # (size, [stride in each tensor])
    for i, n in enumerate(lead):
        if n == 1:
            continue
        st = [t.stride(i) for t in ts]
        if dims and all(x == y * n for x, y in zip(dims[-1][1], st)):
            dims[-1] = (dims[-1][0] * n, st)
        else:
            dims.append((n, st))
    if len(dims) > LEAD_DIMS:
        raise ValueError(f"flash_attention: leading dims {lead} with "
                         f"these strides need {len(dims)} indices, the "
                         f"kernel takes {LEAD_DIMS}")
    dims = [(1, [0] * len(ts))] * (LEAD_DIMS - len(dims)) + dims
    strides = [st[j] for j in range(len(ts)) for st in
               [d[1] for d in dims] + [[t.stride(-2) for t in ts]]]
    per = 16 // q.element_size()
    if any(x % per for x in strides):
        raise ValueError(f"flash_attention: strides {strides} are not all "
                         f"multiples of {per} elements")
    return [d[0] for d in dims], strides


def _map(lead, st, rows: int, d: int, size: int):
    """One TMA map: 5 sizes (d, rows, leading dims 2, 1, 0) and the byte
    strides of its 4 outer dims, from a tensor's element strides ``st``
    (leading dims 0-2, rows).  A leading dim where the tensor has stride 0
    (k and v broadcast over the group) has size 1 there, so the kernel
    gives it coordinate 0; the hardware takes no stride 0.  A dim of size
    1 gets a stride past everything before it, since the hardware reads
    no stride there."""
    outer = [(rows, st[3])] + [(n if x else 1, x)
                               for n, x in zip(lead[::-1], st[2::-1])]
    dims, bstrides = [d] + [n for n, _ in outer], []
    span = d * size                      # bytes up to the current dim
    for n, x in outer:
        if n > 1 and x == 0:
            raise ValueError(f"flash_attention: stride 0 over {n} rows")
        b = x * size if n > 1 else span
        bstrides.append(b)
        span = max(span, b * n)
    return dims, bstrides


def tensor_maps(q, k, v, out, *more):
    """What the bf16 kernels' TMA maps describe: returns (lead, dims,
    strides, out_strides).  ``lead`` and the element strides come from
    ``kernel_layout`` over q, k, v, out and ``more``.  Per map of q, k and
    v in turn (the forward reads those three), ``dims`` holds 5 sizes (d,
    rows, leading dims 2, 1, 0) and ``strides`` the byte strides of its 4
    outer dims (``_map``).  ``out_strides``: the element strides
    (leading dims 0-2, rows) of out and of each of ``more``, the kernels'
    stores."""
    lead, strides = kernel_layout(q, k, v, out, *more)
    S, d = q.shape[-2:]
    T = k.shape[-2]
    dims, bstrides = [], []
    for j, rows in enumerate((S, T, T)):
        dm, bs = _map(lead, strides[4 * j:4 * j + 4], rows, d,
                      q.element_size())
        dims += dm
        bstrides += bs
    return lead, dims, bstrides, strides[12:]


def _launch(q, k, v, causal, return_lse):
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
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device) \
        if return_lse else None
    if any(t.data_ptr() % 16 for t in (q, k, v, out)):
        raise ValueError("flash_attention: a tensor is not 16-byte aligned")
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if return_lse else None)
    if q.dtype == torch.bfloat16:
        lead, dims, strides, out_strides = tensor_maps(q, k, v, out)
        if math.prod(lead) and S:
            fn = build.entry("flash_attention", "flash_attention_sm90_launch",
                             _SM90_ARGTYPES)
            build.check(fn(*ptrs, _arr(dims), _arr(strides), _arr(lead),
                           _arr(out_strides), S, T, d, int(causal),
                           build.stream_ptr(q.device)), "flash_attention")
            launches += 1
    else:
        lead, strides = kernel_layout(q, k, v, out)
        if math.prod(lead) and S:
            fn = build.entry("flash_attention", "flash_attention_launch",
                             _ARGTYPES)
            build.check(fn(*ptrs, _arr(lead), _arr(strides), S, T, d,
                           int(causal), build.stream_ptr(q.device)),
                        "flash_attention")
            launches += 1
    return (out, lse) if return_lse else out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, bq: int = 128, bk: int = 128,
                    return_lse: bool = False):
    """q ``(..., S, d)``, k/v ``(..., T, d)`` -> ``(..., S, d)`` in q's
    dtype, and with ``return_lse`` each row's logsumexp ``(..., S)`` in
    f32.  A CUDA tensor launches the kernel (or raises); a CPU tensor
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
        return _launch(q, k, v, causal, return_lse)
    return flash_attention_plain(q, k, v, causal=causal,
                                 return_lse=return_lse)


# ------------------------------------------------------------- backward --

# flash_attention_bwd_launch(q, k, v, o, do, lse, dq, dk, dv, scratch,
#                            lead[3], strides[32], S, T, D, causal, stream)
_BWD_ARGTYPES = [ctypes.c_void_p] * 10 + [_LL] * 2 + [ctypes.c_int] * 4 \
    + [ctypes.c_void_p]
# flash_attention_bwd_sm90_launch(q, k, v, o, do, lse, dq, dk, dv, scratch,
#                                 dims[25], strides[20], lead[3],
#                                 out_strides[12], S, T, D, causal, stream)
_BWD_SM90_ARGTYPES = [ctypes.c_void_p] * 10 + [_LL] * 4 \
    + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def _sum_to(t: torch.Tensor, shape) -> torch.Tensor:
    """``t`` summed over the dims where ``shape`` has 1 and ``t`` more:
    the gradient of a tensor that broadcast to ``t``'s shape."""
    dims = [i for i, (n, m) in enumerate(zip(t.shape, shape))
            if m == 1 and n != 1]
    return t.sum(dim=dims, keepdim=True) if dims else t


def flash_attention_bwd_plain(q, k, v, out, dout, lse, *,
                              causal: bool = True):
    """Plain PyTorch version of the backward kernel, on any device, in
    f32: scores s = q.k / sqrt(d) (masked at -1e30), P = exp(s - lse) with
    the forward's ``lse``, D = rowsum(dout * out), dP = dout v^T, dS = P
    (dP - D); dq = dS k / sqrt(d), dk = dS^T q / sqrt(d), dv = P^T dout,
    dk and dv summed over the leading dims k and v broadcast over.
    Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    qf, kf, vf = (t.to(torch.float32) for t in (q, k, v))
    dof = dout.to(torch.float32)
    p = torch.exp(_masked_scores(q, k, causal) - lse[..., None])
    delta = (dof * out.to(torch.float32)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(dof, vf.transpose(-1, -2)) - delta)
    dq = torch.matmul(ds, kf) * scale
    dk = _sum_to(torch.matmul(ds.transpose(-1, -2), qf) * scale, k.shape)
    dv = _sum_to(torch.matmul(p.transpose(-1, -2), dof), v.shape)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def bwd_layout(q, k, v, out, dout, dq, dk, dv):
    """What the bf16 backward kernels read and write, all in place: the
    model's views need no copy and no reordering.  Returns (lead, dims,
    strides, out_strides): ``kernel_layout``'s leading sizes over the
    eight tensors; per TMA map of q, k, v, out and dout in turn its 5
    sizes and 4 byte strides (``_map``: k's and v's broadcast dims have
    size 1, which also tells the kernels which dims a kv head owns and
    which its G query heads run over); the element strides (leading dims
    0-2, rows) of dq, dk and dv, the kernels' stores."""
    lead, dims, bstrides, st = tensor_maps(q, k, v, out, dout, dq, dk, dv)
    S, d = q.shape[-2:]
    for st4 in (st[:4], st[4:8]):        # out and dout, q-shaped
        dm, bs = _map(lead, st4, S, d, q.element_size())
        dims += dm
        bstrides += bs
    return lead, dims, bstrides, st[8:]


def bwd_launch_args(q, k, v, out, dout, lse, dq, dk, dv, scratch):
    """The arguments, before the stream, of the entry point that takes
    these tensors' dtype: the tensors' own data pointers and their
    layout (bf16: ``bwd_layout``'s maps; f32: ``kernel_layout``'s element
    strides), then S, T, d."""
    S, d = q.shape[-2:]
    ptrs = [t.data_ptr() for t in (q, k, v, out, dout, lse, dq, dk, dv,
                                   scratch)]
    if q.dtype == torch.bfloat16:
        lead, dims, strides, out_strides = bwd_layout(q, k, v, out, dout,
                                                      dq, dk, dv)
        return [*ptrs, _arr(dims), _arr(strides), _arr(lead),
                _arr(out_strides), S, k.shape[-2], d]
    lead, strides = kernel_layout(q, k, v, out, dout, dq, dk, dv)
    return [*ptrs, _arr(lead), _arr(strides), S, k.shape[-2], d]


def _launch_bwd(q, k, v, out, dout, lse, causal):
    global bwd_launches
    build.require_cuda("flash_attention_bwd", q, k, v, out, dout,
                       dtypes=(q.dtype,) * 5, contiguous=False)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash_attention_bwd: {q.dtype}, expected float32 "
                        f"or bfloat16")
    S, d = q.shape[-2:]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {d}, the kernel "
                         f"takes {HEAD_DIMS}")
    if lse.dtype != torch.float32 or lse.device != q.device \
            or not lse.is_contiguous():
        raise ValueError("flash_attention_bwd: lse is not a contiguous f32 "
                         "tensor on q's device")
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    n_q = math.prod(q.shape[:-2])
    if n_q == 0 or S == 0:
        return dq, dk.zero_(), dv.zero_()
    bf16 = q.dtype == torch.bfloat16
    rows = -(-S // LSE_ROWS) * LSE_ROWS if bf16 else S
    scratch = torch.empty((1 + bf16) * n_q * rows, dtype=torch.float32,
                          device=q.device)
    args = bwd_launch_args(q, k, v, out, dout, lse, dq, dk, dv, scratch)
    if any(p % 16 for p in args[:10]):
        raise ValueError("flash_attention_bwd: a tensor is not 16-byte "
                         "aligned")
    fn = build.entry("flash_attention_bwd",
                     "flash_attention_bwd_sm90_launch" if bf16
                     else "flash_attention_bwd_launch",
                     _BWD_SM90_ARGTYPES if bf16 else _BWD_ARGTYPES)
    build.check(fn(*args, int(causal), build.stream_ptr(q.device)),
                "flash_attention_bwd")
    bwd_launches += 2
    return dq, dk, dv


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True):
    """Gradients (dq, dk, dv) of ``flash_attention(q, k, v, causal)`` for
    the output gradient ``dout``, given the forward's output ``out`` and
    its ``lse`` (``return_lse=True``): q, out, dout ``(..., S, d)``, lse
    ``(..., S)`` f32; k, v ``(..., T, d)``, broadcast over q's leading
    dims (dk and dv come back with k's and v's shapes, summed over the
    dims they broadcast over).  A CUDA tensor launches the kernel (or
    raises); a CPU tensor takes the plain version."""
    if q.shape != out.shape or q.shape != dout.shape or k.shape != v.shape \
            or k.dim() != q.dim() or k.shape[-1] != q.shape[-1] \
            or lse.shape != q.shape[:-1]:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, out "
                         f"{tuple(out.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if k.shape[-2] == 0:
        raise ValueError("flash_attention_bwd: no keys (T = 0)")
    if any(n not in (m, 1) for n, m in zip(k.shape[:-2], q.shape[:-2])):
        raise ValueError(f"flash_attention_bwd: kv leading dims "
                         f"{tuple(k.shape[:-2])} do not broadcast to "
                         f"{tuple(q.shape[:-2])}")
    if q.is_cuda:
        return _launch_bwd(q, k, v, out, dout, lse, causal)
    return flash_attention_bwd_plain(q, k, v, out, dout, lse, causal=causal)


def _strided_ok(t: torch.Tensor) -> bool:
    """Whether a gradient's strides can go to the kernel's maps as they
    are: the head dim contiguous and no dim of size > 1 broadcast."""
    return t.stride(-1) == 1 and all(s or n == 1
                                     for n, s in zip(t.shape, t.stride()))


class FlashAttentionFn(torch.autograd.Function):
    """Attention whose forward is ``flash_attention`` and whose backward is
    ``flash_attention_bwd``; it saves q, k, v, the output and its lse.
    The output's gradient goes to the backward as autograd hands it over
    (the model's comes in the output's own memory order), unless its
    strides broadcast (the gradient of ``out.sum()``, say): only then is a
    dense copy made."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out, lse = flash_attention(q, k, v, causal=causal, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        if not _strided_ok(dout):
            dout = dout.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout, lse,
                                         causal=ctx.causal)
        return dq, dk, dv, None


def flash_attention_train(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True) -> torch.Tensor:
    """``flash_attention`` with a gradient (the training path's
    attention)."""
    return FlashAttentionFn.apply(q, k, v, causal)
