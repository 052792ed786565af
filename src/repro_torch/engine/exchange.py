"""Send/Recv (paper §6.1): data movement between the shards of a mesh.

Mirrors ``src/repro/engine/exchange.py``.  The paper's Send operator
'segments data such that all alike values are sent to the same node, so
each node computes full results independently' -- a resegmentation.
Broadcast (replicating a small build side) is an all_gather.  The
optimizer picks between co-located (no exchange), resegment, and broadcast
(planner/cost).

The port's mesh splits its shards into placements, one device each
(distributed/mesh.py): a sharded array is one ``[k, n_local]`` tensor per
placement.  The reference's ``shard_map``-ped collectives become, from one
controller process:

* each source block builds its ``[k_src, n_shards, per]`` send buffer on
  its own device (the reference's per-shard ``[dst, per]`` buffers);
* the all_to_all hands destination block ``j`` of every source to
  placement ``j`` -- device-to-device copies (``Tensor.to``: peer access
  over NVLink where the cards have it, nothing where a placement shares
  the source's device), concatenated along the source dimension;
* the ``psum`` of the overflow counts sums every block's counts on the
  first placement's device;
* the tiled ``all_gather`` copies the concatenation of the blocks to
  every placement's device.

A source may also be one whole ``[n_shards, n_local]`` tensor on any
device (the segmented slab build sends the decoded snapshot from the
database's device).  The output layout is the reference's: destination
shard major, then source shard, then slot.  ``transfer_bytes`` counts the
bytes the collectives handed from one placement to another, and the part
of them that crossed between devices.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple, Union

import torch

Blocks = Union[torch.Tensor, Sequence[torch.Tensor]]

# bytes handed between placements since the last reset, and the part of
# them copied from one device to another
_moved = {"between_placements": 0, "cross_card": 0}


def transfer_bytes() -> Dict[str, int]:
    """Bytes the collectives handed from one placement to another since
    the last reset, and the part of them that crossed between devices."""
    return dict(_moved)


def reset_transfer_bytes() -> None:
    for k in _moved:
        _moved[k] = 0


def _hand(t: torch.Tensor, device: torch.device, other: bool
          ) -> torch.Tensor:
    """``t`` on ``device``, counted when it goes to another placement
    (``other``); a copy only where it lies on another device."""
    if other:
        _moved["between_placements"] += t.numel() * t.element_size()
    if t.device == device:
        return t
    _moved["cross_card"] += t.numel() * t.element_size()
    return t.to(device)


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


def _send_buffers(n_shards: int, per: int, dest: torch.Tensor,
                  vals: Tuple[torch.Tensor, ...]
                  ) -> Tuple[Tuple[torch.Tensor, ...], torch.Tensor,
                             torch.Tensor]:
    """One source block's side of the exchange, on its own device.
    ``dest`` is the ``[k_src, n_local]`` destination shard of each row;
    returns (a ``[k_src, n_shards, per]`` send buffer per value, the
    same of the kept flags, and the ``(n_shards,)`` int32 count of rows
    this block could not fit, per destination)."""
    n_src, n_local = dest.shape
    dev = dest.device
    # slot of each row within its (source, destination) bucket
    pos, counts = _ranks(dest, n_shards)
    keep = pos < per
    overflow = torch.clamp(counts - per, min=0).sum(0).to(torch.int32)
    # overflowing rows write to a scratch slot (per) that is sliced off
    # -- writing them to per-1 would clobber the legitimate last slot and
    # silently drop one MORE tuple than reported
    slot = torch.where(keep, pos, per)
    src = torch.arange(n_src, device=dev).unsqueeze(1)
    flat = ((src * n_shards + dest.to(torch.int64)) * (per + 1)
            + slot).reshape(-1)

    def send(v: torch.Tensor) -> torch.Tensor:
        buf = torch.zeros(n_src * n_shards * (per + 1), dtype=v.dtype,
                          device=dev)
        buf[flat] = torch.where(keep, v, torch.zeros(
            (), dtype=v.dtype, device=dev)).reshape(-1)
        return buf.reshape(n_src, n_shards, per + 1)[:, :, :per]

    return tuple(send(v) for v in vals), send(keep), overflow


def _all_to_all(mesh, bufs: Sequence[torch.Tensor],
                sources: Sequence[Optional[int]]) -> List[torch.Tensor]:
    """Hand destination block ``j`` of every source's ``[k_src, n_shards,
    per]`` send buffer to placement ``j``: one ``[k, n_src * per]`` tensor
    per placement, destination shard major, then source shard (sources in
    order), then slot.  ``sources[b]`` is the placement that holds buffer
    ``b``, or None where it is no placement's."""
    k = mesh.shards_per_placement
    out = []
    for j, (lo, dev) in enumerate(mesh.placements()):
        parts = [_hand(buf[:, lo:lo + k], dev, src != j)
                 for buf, src in zip(bufs, sources)]
        got = parts[0] if len(parts) == 1 else torch.cat(parts)
        out.append(got.transpose(0, 1).reshape(k, -1))
    return out


def resegment_blocks(mesh, per: int, dest: Sequence[torch.Tensor],
                     vals: Sequence[Tuple[torch.Tensor, ...]],
                     sources: Optional[Sequence[Optional[int]]] = None
                     ) -> Tuple[List[Tuple[torch.Tensor, ...]],
                                List[torch.Tensor], torch.Tensor]:
    """The resegment over source blocks, callable from a stage program of
    the segmented executor.  ``dest[b]`` and each of ``vals[b]`` are
    source block ``b``'s ``[k_b, n_local_b]`` rows, on one device; the
    blocks are the mesh's placements unless ``sources`` says which
    placement (or None) holds each.  Returns, per placement, the moved
    value tuple and the valid mask, each ``[k, n_src * per]``, and the
    ``(n_shards,)`` int32 overflow on the first placement's device."""
    n_shards = mesh.n_shards
    if sources is None:
        if len(dest) != len(mesh.devices):
            raise ValueError(f"resegment: {len(dest)} source blocks for "
                             f"{len(mesh.devices)} placements")
        sources = range(len(dest))
    sent = [_send_buffers(n_shards, per, d, v) for d, v in zip(dest, vals)]
    n_vals = len(vals[0]) if len(vals) else 0
    moved = [_all_to_all(mesh, [s[0][i] for s in sent], sources)
             for i in range(n_vals)]
    valid = _all_to_all(mesh, [s[1] for s in sent], sources)
    # the psum: every block's per-destination overflow, summed
    overflow = sent[0][2].to(mesh.device)
    for s in sent[1:]:
        overflow = overflow + s[2].to(mesh.device)
    outs = [tuple(m[p] for m in moved) for p in range(len(mesh.devices))]
    return outs, valid, overflow


def resegment(mesh, axis: str, cols: Dict[str, Blocks], dest: Blocks,
              capacity: int
              ) -> Tuple[Dict[str, Blocks], Blocks, torch.Tensor]:
    """Move each row to the shard ``dest[s, i]`` (hash-segmentation
    target).

    ``dest`` and every column are either one ``[n_shards, n_local]``
    tensor (every source shard's rows, on any device) or a list of the
    placements' ``[k, n_local]`` blocks; the moved columns and ``valid``
    come back the same way -- a tensor input gives the placements'
    blocks concatenated on the first placement's device.

    Returns (columns, valid, overflow) with per-shard static capacity.
    ``overflow`` is an (n_shards,) int32 count of tuples destined to each
    shard that did NOT fit in ``capacity // n_shards`` slots per source
    and were dropped -- callers MUST check it (``overflow.sum() == 0``)
    and either retry with a larger capacity or fail loudly; silent
    truncation is a wrong answer, not a slow one."""
    n_shards = mesh.shape[axis]
    names = list(cols)
    whole = isinstance(dest, torch.Tensor)
    if whole:
        dest_b, sources = [dest], [None]
        vals = [tuple(cols[c] for c in names)]
    else:
        dest_b, sources = list(dest), None
        vals = [tuple(cols[c][b] for c in names) for b in range(len(dest_b))]
    outs, valid, overflow = resegment_blocks(
        mesh, capacity // n_shards, dest_b, vals, sources)
    moved = {c: [o[i] for o in outs] for i, c in enumerate(names)}
    if whole:
        return ({c: mesh.gather(v) for c, v in moved.items()},
                mesh.gather(valid), overflow)
    return moved, valid, overflow


def broadcast_build_side(mesh, axis: str, cols: Dict[str, Blocks]
                         ) -> Dict[str, Blocks]:
    """Replicate a (small) build side to every shard: the tiled all_gather
    of the ``[k, per]`` blocks is their concatenation, one ``(n_shards *
    per,)`` tensor per placement (placements on one device share it).  A
    whole ``[n_shards, per]`` tensor gives the one flat tensor on its own
    device."""
    out = {}
    for c, v in cols.items():
        if isinstance(v, torch.Tensor):
            out[c] = v.reshape(-1)
            continue
        by_dev = {}
        placed = []
        for j, (_, dev) in enumerate(mesh.placements()):
            if dev not in by_dev:
                by_dev[dev] = torch.cat([_hand(b.reshape(-1), dev, i != j)
                                         for i, b in enumerate(v)])
            placed.append(by_dev[dev])
        out[c] = placed
    return out
