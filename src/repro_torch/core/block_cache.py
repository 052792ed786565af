"""Device-resident block cache: a byte-budgeted LRU over column blocks.

Vertica's execution engine is fast because the blocks it scans are already
sitting in the OS page cache, still encoded (paper §6: the EE operates on
encoded data wherever it can, and §7 credits warm scans for most of the
production speedup).  Our analog keeps *device* (HBM) copies of container
column payloads -- both the encoded arrays and the decoded
``(n_blocks, block_rows)`` blocks -- so a repeat query never re-uploads or
re-decodes a column it has already touched.

Keys are ``(container_id, column, kind)``.  ROS containers are immutable
(§3.7), which makes this cache trivially coherent: an entry can only go
stale when its container is *retired*, so invalidation hooks live exactly
where containers die --

  * ``tuple_mover.mergeout``    -- merged-away containers,
  * ``database._apply_delete``  -- containers gaining a delete vector
                                   (defensive: masks are keyed by epoch,
                                   but eager eviction keeps DV rewrites
                                   honest),
  * ``database.drop_partition`` -- dropped containers.

Budget accounting is by device bytes; eviction is two-tier LRU: derived
entries (decoded blocks, slabs, union scans) evict strictly LRU-first, and
only when none remain do the *packed* ``KIND_ENCODED`` payloads go -- they
are the compressed-domain executor's ground truth, typically 2-8x smaller
than their decoded form, and everything else can be recomputed from them
on device without another host upload (``protect_packed=False`` restores
the flat LRU for baseline measurements).  The cache is
deliberately jax-agnostic: values are opaque, sizes are passed in by the
caller (engine/executor.py computes them from array shapes), so host-only
storage code can import this module without pulling in jax.

See DESIGN.md §11 ("Block cache & plan cache").

Mirrors ``src/repro/core/block_cache.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Hashable, Iterable, Optional, Tuple

# (container_id, column, kind); container_id is an int for physical ROS
# containers, or a string namespace for derived entries ("dim:<table>"
# build sides, "seg:<projection>" partitioned slabs) whose column field
# may itself be a structured tuple key
CacheKey = Tuple[int, str, str]

# entry kinds used by the executor
KIND_ENCODED = "encoded"                  # dict of device payload arrays
KIND_DECODED = "decoded"                  # (n_blocks, block_rows) device array
KIND_SEG = "segmented"                    # per-shard partitioned scan slabs
KIND_WOS = "wos_slab"                     # per-shard device WOS buffers
KIND_UNION = "union_scan"                 # serving-tier assembled union scans


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    insertions: int = 0
    evictions: int = 0
    invalidations: int = 0
    bytes_in_use: int = 0
    # admission-control working-set reservations (engine/serving.py)
    reserved_bytes: int = 0
    peak_reserved_bytes: int = 0

    def hit_rate(self) -> float:
        n = self.hits + self.misses
        return self.hits / n if n else 0.0


class BlockCache:
    """Byte-budgeted LRU of device-resident column blocks."""

    def __init__(self, budget_bytes: int = 256 << 20, *,
                 protect_packed: bool = True):
        assert budget_bytes > 0
        self.budget_bytes = int(budget_bytes)
        self.protect_packed = protect_packed
        self.stats = CacheStats()
        # key -> (value, nbytes); insertion order == LRU order
        self._entries: "OrderedDict[CacheKey, Tuple[Any, int]]" = \
            OrderedDict()
        # container_id -> set of its keys (for O(keys-of-container)
        # invalidation when the tuple mover retires it)
        self._by_container: Dict[int, set] = {}

    # ------------------------------------------------------------ reads --

    def get(self, container_id: int, column: str, kind: str) -> Optional[Any]:
        key = (container_id, column, kind)
        hit = self._entries.get(key)
        if hit is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(key)
        self.stats.hits += 1
        return hit[0]

    def get_or_put(self, container_id: int, column: str, kind: str,
                   factory, nbytes_of) -> Any:
        """Fetch, or build via ``factory()`` and insert with
        ``nbytes_of(value)`` bytes charged."""
        v = self.get(container_id, column, kind)
        if v is None:
            v = factory()
            self.put(container_id, column, kind, v, int(nbytes_of(v)))
        return v

    # ----------------------------------------------------------- writes --

    def put(self, container_id: int, column: str, kind: str, value: Any,
            nbytes: int) -> bool:
        """Insert (or refresh) an entry; returns False when the item alone
        exceeds the budget (never cached -- a scan larger than HBM budget
        must stream)."""
        nbytes = int(nbytes)
        if nbytes > self.budget_bytes:
            return False
        key = (container_id, column, kind)
        old = self._entries.pop(key, None)
        if old is not None:
            self.stats.bytes_in_use -= old[1]
        self._entries[key] = (value, nbytes)
        self._by_container.setdefault(container_id, set()).add(key)
        self.stats.bytes_in_use += nbytes
        self.stats.insertions += 1
        self._evict_to_budget()
        return True

    def _evict_to_budget(self):
        while self.stats.bytes_in_use > self.budget_bytes and self._entries:
            key = next(iter(self._entries))          # LRU head
            if self.protect_packed and key[2] == KIND_ENCODED:
                # packed payloads go last: evict the LRU-first *derived*
                # entry instead, if any derived entry remains
                key = next((k for k in self._entries
                            if k[2] != KIND_ENCODED), key)
            _, nbytes = self._entries.pop(key)
            self.stats.bytes_in_use -= nbytes
            self.stats.evictions += 1
            keys = self._by_container.get(key[0])
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del self._by_container[key[0]]

    # ----------------------------------------- working-set reservations --
    # Admission control (engine/serving.py) charges each dispatched query
    # mix's estimated decoded working set here before executing it.
    # Reservations never insert or evict entries -- the LRU handles actual
    # residency -- they bound how much NEW working set concurrently
    # admitted queries may open at once against the same byte budget the
    # LRU answers to, which is the paper's "resource manager sizes
    # concurrent query budgets against physical memory" (§7).
    #
    # Under the pipelined serving core a reservation is held from device
    # DISPATCH until the drain stage harvests the unit's futures, so many
    # units' reservations overlap; ``take`` hands out a Reservation token
    # whose ``release`` is idempotent -- dispatch-crash, drain-crash and
    # normal-completion paths may all try to release, exactly one wins.

    def take(self, nbytes: int) -> "Reservation":
        self.reserve(nbytes)
        return Reservation(self, int(nbytes))

    def reserve(self, nbytes: int) -> int:
        self.stats.reserved_bytes += int(nbytes)
        self.stats.peak_reserved_bytes = max(self.stats.peak_reserved_bytes,
                                             self.stats.reserved_bytes)
        return self.stats.reserved_bytes

    def release(self, nbytes: int) -> int:
        self.stats.reserved_bytes = max(0,
                                        self.stats.reserved_bytes
                                        - int(nbytes))
        return self.stats.reserved_bytes

    def headroom(self) -> int:
        """Budget bytes not yet claimed by a live reservation."""
        return max(0, self.budget_bytes - self.stats.reserved_bytes)

    # ----------------------------------------------------- invalidation --

    def invalidate_container(self, container_id: int) -> int:
        """Drop every entry of one (retired) container; returns the number
        of entries evicted."""
        keys = self._by_container.pop(container_id, None)
        if not keys:
            return 0
        n = 0
        for key in keys:
            ent = self._entries.pop(key, None)
            if ent is not None:
                self.stats.bytes_in_use -= ent[1]
                self.stats.invalidations += 1
                n += 1
        return n

    def invalidate_containers(self, ids: Iterable[int]) -> int:
        return sum(self.invalidate_container(cid) for cid in ids)

    def invalidate_where(self, container_id, pred) -> int:
        """Drop the subset of one container-id's entries whose key
        satisfies ``pred(key)`` -- precise invalidation for composite
        entries (the segmented executor's ``seg:<projection>`` slabs key
        each entry by the exact (container set, WOS state, epoch, mesh)
        it was built from, so retiring ONE container evicts exactly the
        slabs that referenced it, not the projection's whole slab set)."""
        keys = self._by_container.get(container_id)
        if not keys:
            return 0
        dead = [k for k in keys if pred(k)]
        n = 0
        for key in dead:
            keys.discard(key)
            ent = self._entries.pop(key, None)
            if ent is not None:
                self.stats.bytes_in_use -= ent[1]
                self.stats.invalidations += 1
                n += 1
        if not keys:
            self._by_container.pop(container_id, None)
        return n

    def clear(self):
        self._entries.clear()
        self._by_container.clear()
        self.stats.bytes_in_use = 0

    # ------------------------------------------------------------- misc --

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: CacheKey) -> bool:
        return key in self._entries

    def keys(self):
        return list(self._entries.keys())


class Reservation:
    """A live working-set reservation against one BlockCache budget.
    ``release()`` returns the bytes exactly once no matter how many
    failure/completion paths call it."""

    __slots__ = ("cache", "nbytes", "live")

    def __init__(self, cache: "BlockCache", nbytes: int):
        self.cache = cache
        self.nbytes = nbytes
        self.live = True

    def release(self) -> None:
        if self.live:
            self.live = False
            self.cache.release(self.nbytes)
