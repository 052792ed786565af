"""Epoch management (paper §5, §5.1).

Commits advance the epoch (the post-C-Store change: automatic advancement on
DML commit, fixing the READ COMMITTED visibility confusion). Snapshot reads
need no locks: a query targets ``current_epoch - 1`` by default and sees
exactly the rows with commit_epoch <= target < delete_epoch.

LGE (Last Good Epoch): per (projection, node) -- everything up to it has
been moved out of the WOS to disk; data past it is lost if the node dies.
AHM (Ancient History Mark): history before it may be purged by mergeout;
it does not advance while nodes are down (they will need the history to
replay).

Cluster snapshot epochs: a query *pins* its snapshot epoch for its whole
lifetime (``snapshot()``), so trickle-load commits advancing
``current_epoch`` concurrently can never shift what the query sees, and
the AHM never advances past a pinned snapshot -- mergeout may not purge
history a running query still reads.

Mirrors ``src/repro/core/epochs.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Dict, Iterator, Optional, Tuple


@dataclasses.dataclass
class EpochManager:
    current_epoch: int = 1
    ahm: int = 0
    # (projection, node) -> last good epoch
    lge: Dict[Tuple[str, int], int] = dataclasses.field(default_factory=dict)
    # epoch -> number of live query snapshots pinned at it
    pins: Counter = dataclasses.field(default_factory=Counter)

    def advance(self) -> int:
        """Commit boundary: every committed txn gets the pre-advance epoch."""
        e = self.current_epoch
        self.current_epoch += 1
        return e

    def latest_queryable(self) -> int:
        return self.current_epoch - 1

    # ------------------------------------------------- snapshot pinning --

    def pin(self, epoch: Optional[int] = None) -> int:
        """Pin a cluster snapshot epoch for a running query.  Commits may
        keep advancing ``current_epoch``; the pinned epoch stays a
        consistent read point and caps the AHM until released."""
        e = epoch if epoch is not None else self.latest_queryable()
        self.pins[e] += 1
        return e

    def unpin(self, epoch: int) -> None:
        self.pins[epoch] -= 1
        if self.pins[epoch] <= 0:
            del self.pins[epoch]

    def oldest_pinned(self) -> Optional[int]:
        return min(self.pins) if self.pins else None

    def n_pinned(self) -> int:
        """Total live snapshot pins across all epochs.  Zero means nothing
        is holding the AHM back -- the serving layer's pin-lifecycle
        invariant (every admitted/rejected/timed-out query released its
        pin) is asserted against this."""
        return int(sum(self.pins.values()))

    @contextlib.contextmanager
    def snapshot(self, epoch: Optional[int] = None) -> Iterator[int]:
        """``with epochs.snapshot() as e:`` -- a pinned consistent read."""
        e = self.pin(epoch)
        try:
            yield e
        finally:
            self.unpin(e)

    def set_lge(self, projection: str, node: int, epoch: int):
        key = (projection, node)
        self.lge[key] = max(self.lge.get(key, 0), epoch)

    def get_lge(self, projection: str, node: int) -> int:
        return self.lge.get((projection, node), 0)

    def cluster_lge(self, projection: str, nodes) -> int:
        return min((self.get_lge(projection, n) for n in nodes), default=0)

    def advance_ahm(self, to_epoch: Optional[int] = None, *,
                    nodes_down: bool = False):
        """AHM policy: advance to the min cluster LGE (or explicit target),
        never past it, never while nodes are down (paper §5.1), and never
        past the oldest pinned query snapshot -- purging history a live
        snapshot still reads would un-MVCC the read."""
        if nodes_down:
            return
        target = to_epoch if to_epoch is not None else \
            min(self.lge.values(), default=0)
        pinned = self.oldest_pinned()
        if pinned is not None:
            target = min(target, pinned - 1)
        self.ahm = max(self.ahm, min(target, self.latest_queryable()))

    def visible(self, commit_epochs, delete_mask_epochs=None,
                as_of: Optional[int] = None):
        """Row visibility at a snapshot (vectorized over numpy arrays)."""
        e = as_of if as_of is not None else self.latest_queryable()
        vis = commit_epochs <= e
        if delete_mask_epochs is not None:
            vis &= ~delete_mask_epochs
        return vis
