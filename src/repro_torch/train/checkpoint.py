"""Epoch-based, K-safe checkpointing (the paper's §5 semantics applied to
training state -- DESIGN.md §3 integration).

Mirrors ``src/repro/train/checkpoint.py`` verbatim but for ``jax.tree``,
which is ``train/tree.py`` here (jax's leaf order: dict keys sorted), and
for leaves that are tensors, saved through numpy: the on-disk format and
leaf order are the reference's, so each package restores the other's
checkpoint.

* A checkpoint commit = an epoch. The Last Good Epoch is the newest
  checkpoint fully persisted on every shard; recovery resumes from it and
  replays the (deterministic, epoch-pinned) data stream since.
* K-safety: every state shard is written to its primary directory AND a
  ring-offset buddy directory; losing one location recovers from the other
  (restore_shard tries primary, falls back to buddy).
* AHM: checkpoints older than the Ancient History Mark are garbage
  collected; the AHM never advances past the cluster LGE.
* Saves are atomic (tmp + rename) and shard-parallel in a real deployment;
  data+epoch is the whole log -- no separate WAL, exactly the paper.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
import shutil
import tempfile
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .tree import tree_flatten, tree_map, tree_unflatten


def _np(x) -> np.ndarray:
    """A leaf as numpy (a tensor is copied to the host)."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@dataclasses.dataclass
class CheckpointStore:
    root: pathlib.Path
    n_shards: int
    k_safety: int = 1

    def __post_init__(self):
        self.root = pathlib.Path(self.root)
        self.root.mkdir(parents=True, exist_ok=True)

    # ---------------------------------------------------------- layout --

    def _dir(self, epoch: int, shard: int, buddy: bool) -> pathlib.Path:
        kind = "buddy" if buddy else "primary"
        host = (shard + 1) % self.n_shards if buddy else shard
        return self.root / f"epoch_{epoch:08d}" / f"node_{host}" / \
            f"{kind}_shard_{shard}"

    # ------------------------------------------------------------ save --

    def save_shard(self, epoch: int, shard: int, state: Dict[str, Any]):
        """Persist one shard's pytree to primary + buddy locations."""
        flat, treedef = tree_flatten(state)
        arrays = {f"leaf_{i}": _np(x) for i, x in enumerate(flat)}
        for buddy in ([False, True] if self.k_safety >= 1 else [False]):
            d = self._dir(epoch, shard, buddy)
            d.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d)
            with os.fdopen(fd, "wb") as f:
                np.savez(f, **arrays)
            os.replace(tmp, d / "state.npz")

    def commit_epoch(self, epoch: int, meta: Optional[Dict] = None):
        """Mark the epoch complete (the LGE advances to it)."""
        d = self.root / f"epoch_{epoch:08d}"
        (d / "COMMIT").write_text(json.dumps(
            {"epoch": epoch, **(meta or {})}))

    # --------------------------------------------------------- restore --

    def last_good_epoch(self) -> Optional[int]:
        epochs = sorted(
            int(p.name.split("_")[1]) for p in self.root.glob("epoch_*")
            if (p / "COMMIT").exists())
        return epochs[-1] if epochs else None

    def restore_shard(self, epoch: int, shard: int,
                      template: Dict[str, Any], *,
                      lost_nodes: Tuple[int, ...] = ()) -> Dict[str, Any]:
        """Load one shard, preferring the primary copy; if its node is
        'lost', read the buddy (paper §5.2 buddy recovery)."""
        for buddy in (False, True):
            d = self._dir(epoch, shard, buddy)
            host = int(d.parent.name.split("_")[1])
            if host in lost_nodes:
                continue
            f = d / "state.npz"
            if f.exists():
                data = np.load(f)
                flat, treedef = tree_flatten(template)
                loaded = [data[f"leaf_{i}"] for i in range(len(flat))]
                return tree_unflatten(treedef, loaded)
        raise FileNotFoundError(
            f"shard {shard} of epoch {epoch} unavailable "
            f"(lost nodes: {lost_nodes}) -- K-safety exceeded")

    # -------------------------------------------------------------- gc --

    def advance_ahm(self, ahm_epoch: int) -> List[int]:
        """Drop checkpoints strictly older than the AHM; never the newest
        committed one."""
        lge = self.last_good_epoch()
        dropped = []
        for p in sorted(self.root.glob("epoch_*")):
            e = int(p.name.split("_")[1])
            if e < min(ahm_epoch, lge if lge is not None else e + 1):
                shutil.rmtree(p)
                dropped.append(e)
        return dropped


def shard_state(state: Dict[str, Any], shard: int,
                n_shards: int) -> Dict[str, Any]:
    """Slice a replicated state pytree into shard ``shard`` along each
    leaf's largest divisible axis (the simulation's stand-in for the real
    sharded save where each host writes its addressable shards)."""
    def slc(x):
        x = _np(x)
        for ax, size in enumerate(x.shape):
            if size % n_shards == 0 and size >= n_shards:
                w = size // n_shards
                sl = [slice(None)] * x.ndim
                sl[ax] = slice(shard * w, (shard + 1) * w)
                return x[tuple(sl)]
        return x if shard == 0 else np.zeros((0,), x.dtype)
    return tree_map(slc, state)


def unshard_state(shards: List[Dict[str, Any]],
                  template: Dict[str, Any]) -> Dict[str, Any]:
    """Reassemble the full pytree from per-shard slices (leaf-wise, using
    the template to find the sliced axis)."""
    flat_t, treedef = tree_flatten(template)
    flats = [tree_flatten(s)[0] for s in shards]
    out = []
    for i, t in enumerate(flat_t):
        t = _np(t)
        parts = [np.asarray(f[i]) for f in flats]
        if parts[0].shape == t.shape:
            out.append(parts[0])
            continue
        ax = next(a for a in range(t.ndim)
                  if parts[0].shape[a] != t.shape[a])
        out.append(np.concatenate(parts, axis=ax))
    return tree_unflatten(treedef, out)
