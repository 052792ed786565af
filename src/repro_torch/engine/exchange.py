"""Send/Recv (paper §6.1): data movement between the shards of a mesh.

Mirrors ``src/repro/engine/exchange.py``.  The paper's Send operator
'segments data such that all alike values are sent to the same node, so
each node computes full results independently' -- a resegmentation.
Broadcast (replicating a small build side) is an all_gather.  The
optimizer picks between co-located (no exchange), resegment, and broadcast
(planner/cost).

The port's mesh is ``n_shards`` logical shards on one device
(distributed/mesh.py): a sharded array is a ``[n_shards, n_local]``
tensor.  The reference's per-shard ``[dst, per]`` send buffers become one
``[src, dst, per]`` tensor, its ``all_to_all`` the transpose to ``[dst,
src, per]``, its ``psum`` a sum over the source dimension and its tiled
``all_gather`` a concatenation of the shards.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch


def _ranks(dest: torch.Tensor, n_shards: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pos, counts): ``pos[s, i]`` is row i's rank among the rows of
    source shard s bound for the same destination, in row order;
    ``counts[s, d]`` is how many rows of source s are bound for d."""
    n_src, n_local = dest.shape
    src = torch.arange(n_src, device=dest.device).unsqueeze(1)
    bucket = (src * n_shards + dest.to(torch.int64)).reshape(-1)
    counts = torch.bincount(bucket, minlength=n_src * n_shards)
    starts = torch.cumsum(counts, 0) - counts
    order = torch.argsort(bucket, stable=True)
    pos = torch.empty_like(bucket)
    pos[order] = torch.arange(bucket.numel(), device=dest.device) \
        - starts[bucket[order]]
    return pos.reshape(n_src, n_local), counts.reshape(n_src, n_shards)


def resegment_local(n_shards: int, per: int, dest: torch.Tensor,
                    vals: Tuple[torch.Tensor, ...]
                    ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                               torch.Tensor]:
    """The body of :func:`resegment` over every shard at once, callable
    from a stage program of the segmented executor.  ``dest`` is the
    ``[n_shards, n_local]`` destination shard of each row; returns (moved
    value tuple, valid, overflow), each moved value ``[n_shards, n_shards
    * per]`` -- destination shard major, then source shard, then slot."""
    n_src, n_local = dest.shape
    dev = dest.device
    # slot of each row within its (source, destination) bucket
    pos, counts = _ranks(dest, n_shards)
    keep = pos < per
    # rows a source wanted to send to each destination but could not
    # fit, summed over the sources (the reference's psum)
    overflow = torch.clamp(counts - per, min=0).sum(0).to(torch.int32)
    # overflowing rows write to a scratch slot (per) that is sliced off
    # -- writing them to per-1 would clobber the legitimate last slot and
    # silently drop one MORE tuple than reported
    slot = torch.where(keep, pos, per)
    src = torch.arange(n_src, device=dev).unsqueeze(1)
    flat = ((src * n_shards + dest.to(torch.int64)) * (per + 1)
            + slot).reshape(-1)

    def send(v: torch.Tensor, fill) -> torch.Tensor:
        buf = torch.zeros(n_src * n_shards * (per + 1), dtype=v.dtype,
                          device=dev)
        buf[flat] = torch.where(keep, v, fill).reshape(-1)
        # [src, dst, per] -> [dst, src, per]: the all_to_all
        buf = buf.reshape(n_src, n_shards, per + 1)[:, :, :per]
        return buf.transpose(0, 1).reshape(n_shards, n_src * per)

    outs = tuple(send(v, torch.zeros((), dtype=v.dtype, device=dev))
                 for v in vals)
    valid = send(keep, torch.zeros((), dtype=torch.bool, device=dev))
    return outs, valid, overflow


def resegment(mesh, axis: str, cols: Dict[str, torch.Tensor],
              dest: torch.Tensor, capacity: int
              ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor,
                         torch.Tensor]:
    """Move each row to the shard ``dest[s, i]`` (hash-segmentation
    target).

    Returns (columns, valid, overflow) with per-shard static capacity.
    ``overflow`` is an (n_shards,) int32 count of tuples destined to each
    shard that did NOT fit in ``capacity // n_shards`` slots per source
    and were dropped -- callers MUST check it (``overflow.sum() == 0``)
    and either retry with a larger capacity or fail loudly; silent
    truncation is a wrong answer, not a slow one."""
    n_shards = mesh.shape[axis]
    names = list(cols)
    outs, valid, overflow = resegment_local(
        n_shards, capacity // n_shards, dest, tuple(cols[c] for c in names))
    return dict(zip(names, outs)), valid, overflow


def broadcast_build_side(mesh, axis: str, cols: Dict[str, torch.Tensor]
                         ) -> Dict[str, torch.Tensor]:
    """Replicate a (small) build side to every shard: the tiled all_gather
    of ``[n_shards, per]`` shards is their concatenation, one ``(n_shards
    * per,)`` tensor that every shard reads."""
    return {c: v.reshape(-1) for c, v in cols.items()}
