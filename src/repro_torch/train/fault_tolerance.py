"""Fault tolerance and distributed-optimization tricks for the training
loop, built on the Vertica mechanisms (DESIGN.md §3):

* node failure  -> restore the lost rank's state shard from its buddy
                   checkpoint copy + deterministic replay of the
                   epoch-pinned data stream since the LGE,
* elastic scale -> rebalance data shards wholesale (local segments) and
                   re-split the global batch over the new DP size,
* stragglers    -> quorum gradient commit: a step commits once a quorum of
                   DP ranks contributed; laggard contributions are dropped
                   (the paper's commit-on-quorum, no 2PC),
* gradient compression -> DELTA+narrow-int encoding of the DP all-reduce
                   payload (the §3.4 encodings applied to gradients).

Mirrors ``src/repro/train/fault_tolerance.py`` verbatim but for
``jax.tree``, which is ``train/tree.py`` here.  Gradients are numpy
trees, as the reference's host-side helpers take them; a tensor leaf is
copied to the host where the reference calls ``np.asarray``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .checkpoint import _np
from .tree import tree_flatten, tree_map, tree_unflatten


# ---------------------------------------------------------------------------
# Quorum gradient commit (straggler mitigation)
# ---------------------------------------------------------------------------

def quorum_combine(rank_grads: Sequence[Optional[Dict]], *,
                   quorum_frac: float = 0.5) -> Tuple[Dict, int]:
    """Average gradients from the ranks that reported (None = straggler /
    failed). Raises if fewer than a quorum contributed -- identical policy
    to the paper's cluster commit."""
    live = [g for g in rank_grads if g is not None]
    need = int(np.floor(len(rank_grads) * quorum_frac)) + 1
    if len(live) < need:
        raise RuntimeError(
            f"gradient quorum lost: {len(live)}/{len(rank_grads)} "
            f"(need {need})")
    scale = 1.0 / len(live)
    out = tree_map(lambda *xs: sum(xs) * scale, *live)
    return out, len(live)


# ---------------------------------------------------------------------------
# Gradient compression (paper §3.4 encodings on the wire)
# ---------------------------------------------------------------------------

def compress_grads_int8(grads: Dict) -> Tuple[Dict, Dict]:
    """Per-leaf symmetric int8 quantization (the all-reduce payload shrinks
    4x vs f32; scales travel alongside, 8 bytes per leaf)."""
    payload, scales = {}, {}

    def enc(path, g):
        g = _np(g).astype(np.float32)
        s = float(np.max(np.abs(g))) / 127.0 if g.size else 1.0
        s = s or 1.0
        q = np.clip(np.round(g / s), -127, 127).astype(np.int8)
        return q, s

    flat, treedef = tree_flatten(grads)
    qs, ss = [], []
    for g in flat:
        q, s = enc(None, g)
        qs.append(q)
        ss.append(s)
    return ({"q": qs, "tree": treedef}, {"s": ss})


def decompress_grads_int8(payload: Dict, scales: Dict) -> Dict:
    flat = [q.astype(np.float32) * s
            for q, s in zip(payload["q"], scales["s"])]
    return tree_unflatten(payload["tree"], flat)


def compressed_allreduce(rank_grads: List[Dict]) -> Dict:
    """Simulated ring all-reduce with int8 payloads: each rank's
    contribution is quantized before the wire, accumulated in fp32."""
    acc = None
    for g in rank_grads:
        p, s = compress_grads_int8(g)
        d = decompress_grads_int8(p, s)
        acc = d if acc is None else tree_map(np.add, acc, d)
    return tree_map(lambda x: x / len(rank_grads), acc)


# ---------------------------------------------------------------------------
# Failure / elasticity simulation harness
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DPSimulator:
    """Simulated data-parallel group: per-rank state shards with buddy
    recovery and elastic resize, driving a real train_step."""

    world: int
    ranks_up: List[bool] = dataclasses.field(default_factory=list)

    def __post_init__(self):
        if not self.ranks_up:
            self.ranks_up = [True] * self.world

    def fail(self, rank: int):
        self.ranks_up[rank] = False

    def recover(self, rank: int):
        self.ranks_up[rank] = True

    @property
    def n_up(self) -> int:
        return sum(self.ranks_up)

    def split_batch(self, batch: Dict[str, np.ndarray]
                    ) -> List[Optional[Dict[str, np.ndarray]]]:
        """Re-split the global batch over live ranks (elasticity: the
        global batch is invariant; per-rank share changes)."""
        up = [i for i, ok in enumerate(self.ranks_up) if ok]
        n = len(next(iter(batch.values())))
        per = n // len(up)
        out: List[Optional[Dict]] = [None] * self.world
        for j, r in enumerate(up):
            out[r] = {k: v[j * per: (j + 1) * per] for k, v in
                      batch.items()}
        return out
