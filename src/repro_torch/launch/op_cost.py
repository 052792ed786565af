"""Per-card costs of one call, counted on meta tensors.

The port's counterpart of ``src/repro/launch/hlo_cost.py``.  The reference
compiles a step and walks its post-SPMD HLO; the port has no HLO, so it
runs the step itself on meta tensors (shapes and dtypes, no memory, no
arithmetic) and counts the ATen ops one call dispatches:

  flops  -- ``torch.utils.flop_counter.FlopCounterMode``: 2 per
            multiply-add of every matmul, batched matmul and convolution,
            and the flash kernel's own work through its meta route
            (kernels/flash_attention.py: 4 d flops per unmasked pair
            forward, 10 d backward); elementwise ops count none, as in
            the reference's cost model.
  bytes  -- a proxy for HBM traffic, as ``hlo_cost``'s top-level ops
            are: every op but views and allocations is charged the bytes
            of its tensor inputs and outputs (each capped at its
            storage's size, so a broadcast view is read once).  The flash
            meta route's inputs and outputs are exactly what the kernel
            reads and writes; an op the card would fuse is charged
            as if it ran alone.
  peak   -- the largest sum of live bytes over the meta storages the call
            created (activations, saved tensors, gradients, outputs): the
            storages are watched until they are freed.
  args   -- the bytes of the call's arguments (parameters, optimizer
            state, cache, inputs): each tensor's elements.

``Costs`` has ``flops``, ``bytes`` and ``coll_total`` (0: one card moves
nothing over a link), so ``roofline_math.analyze`` takes it as the
reference's takes ``hlo_cost.Costs``.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

aten = torch.ops.aten

# ops that move no bytes: aliases and allocations (the op that fills an
# allocation is charged its write)
_FREE = {aten.detach.default, aten.alias.default, aten._unsafe_view.default,
         aten.lift_fresh.default, aten.empty.memory_format,
         aten.empty_strided.default, aten.empty_like.default,
         aten.new_empty.default, aten.new_empty_strided.default}


@dataclasses.dataclass
class Costs:
    flops: float = 0.0        # counted, per card
    bytes: float = 0.0        # counted op bytes, per card
    peak_bytes: float = 0.0   # largest live sum of the call's own storages
    arg_bytes: float = 0.0    # the call's arguments
    n_ops: int = 0            # ops charged bytes

    @property
    def coll_total(self) -> float:
        return 0.0


def _tensors(tree) -> Iterable[torch.Tensor]:
    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _nbytes(t: torch.Tensor) -> int:
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def tree_bytes(tree) -> int:
    """Bytes of the elements of the tensors in ``tree``."""
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Counter(TorchDispatchMode):
    """Charges each op its input and output bytes and watches the storages
    its outputs create."""

    def __init__(self, known: Iterable[int]):
        super().__init__()
        self.known = set(known)       # storages that were there before
        self.live: Dict[int, int] = {}
        self.now = self.peak = self.bytes = 0
        self.n_ops = 0

    def _freed(self, key: int) -> None:
        self.now -= self.live.pop(key)

    def _watch(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self.known or key in self.live:
            return
        self.live[key] = st.nbytes()
        self.now += st.nbytes()
        self.peak = max(self.peak, self.now)
        weakref.finalize(st, self._freed, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if outs and func not in _FREE and not func.is_view:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs)))
            self.bytes += sum(_nbytes(t) for t in outs)
            self.n_ops += 1
        for t in outs:
            self._watch(t)
        return out


def count(fn: Callable, *args) -> Tuple[Any, Costs]:
    """``fn(*args)`` on meta tensors, and its costs."""
    known = {id(t.untyped_storage()) for t in _tensors(args)}
    counter = _Counter(known)
    with FlopCounterMode(display=False) as flops, counter:
        out = fn(*args)
    return out, Costs(flops=float(flops.get_total_flops()),
                      bytes=float(counter.bytes),
                      peak_bytes=float(counter.peak),
                      arg_bytes=float(tree_bytes(args)),
                      n_ops=counter.n_ops)
