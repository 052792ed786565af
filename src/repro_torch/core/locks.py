"""Table locks: the paper's Tables 1 (compatibility) and 2 (conversion).

Modes: S (shared, serializable reads), I (insert -- compatible with itself:
parallel bulk loads), SI (shared-insert), X (exclusive: delete/update),
T (tuple mover short ops), U (usage: moveout/mergeout), O (owner: drop
partition / add column).

Most queries take NO lock at all (snapshot reads, §5); the lock manager
exists for writers and maintenance.

Mirrors ``src/repro/core/locks.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Set

MODES = ("S", "I", "SI", "X", "T", "U", "O")

# Table 1: Lock Compatibility Matrix. COMPAT[requested][granted] -> bool
_C = {
    "S":  {"S": 1, "I": 0, "SI": 0, "X": 0, "T": 1, "U": 1, "O": 0},
    "I":  {"S": 0, "I": 1, "SI": 0, "X": 0, "T": 1, "U": 1, "O": 0},
    "SI": {"S": 0, "I": 0, "SI": 0, "X": 0, "T": 1, "U": 1, "O": 0},
    "X":  {"S": 0, "I": 0, "SI": 0, "X": 0, "T": 0, "U": 1, "O": 0},
    "T":  {"S": 1, "I": 1, "SI": 1, "X": 0, "T": 1, "U": 1, "O": 0},
    "U":  {"S": 1, "I": 1, "SI": 1, "X": 1, "T": 1, "U": 1, "O": 0},
    "O":  {"S": 0, "I": 0, "SI": 0, "X": 0, "T": 0, "U": 0, "O": 0},
}
COMPATIBLE = {r: {g: bool(v) for g, v in row.items()} for r, row in _C.items()}

# Table 2: Lock Conversion Matrix. CONVERT[requested][granted] -> result mode
CONVERT = {
    "S":  {"S": "S",  "I": "SI", "SI": "SI", "X": "X", "T": "S",  "U": "S",
           "O": "O"},
    "I":  {"S": "SI", "I": "I",  "SI": "SI", "X": "X", "T": "I",  "U": "I",
           "O": "O"},
    "SI": {"S": "SI", "I": "SI", "SI": "SI", "X": "X", "T": "SI", "U": "SI",
           "O": "O"},
    "X":  {"S": "X",  "I": "X",  "SI": "X",  "X": "X", "T": "X",  "U": "X",
           "O": "O"},
    "T":  {"S": "S",  "I": "I",  "SI": "SI", "X": "X", "T": "T",  "U": "T",
           "O": "O"},
    "U":  {"S": "S",  "I": "I",  "SI": "SI", "X": "X", "T": "T",  "U": "U",
           "O": "O"},
    "O":  {"S": "O",  "I": "O",  "SI": "O",  "X": "O", "T": "O",  "U": "O",
           "O": "O"},
}


class LockError(Exception):
    pass


@dataclasses.dataclass
class TableLock:
    mode: Optional[str] = None
    holders: Set[str] = dataclasses.field(default_factory=set)


class LockManager:
    """Per-table locks with the paper's semantics. Non-blocking: a request
    that cannot be granted raises (callers may retry/queue)."""

    def __init__(self):
        self._locks: Dict[str, TableLock] = {}

    def acquire(self, table: str, txn: str, mode: str) -> str:
        assert mode in MODES, mode
        lock = self._locks.setdefault(table, TableLock())
        if lock.mode is None or not lock.holders:
            lock.mode = mode
            lock.holders = {txn}
            return mode
        if lock.holders == {txn}:
            # same holder: convert per Table 2
            lock.mode = CONVERT[mode][lock.mode]
            return lock.mode
        if COMPATIBLE[mode][lock.mode]:
            lock.mode = CONVERT[mode][lock.mode]
            lock.holders.add(txn)
            return lock.mode
        raise LockError(
            f"{txn}: {mode} lock on {table!r} incompatible with granted "
            f"{lock.mode} held by {sorted(lock.holders)}")

    def release(self, table: str, txn: str):
        lock = self._locks.get(table)
        if not lock or txn not in lock.holders:
            return
        lock.holders.discard(txn)
        if not lock.holders:
            lock.mode = None

    def release_all(self, txn: str):
        for t in list(self._locks):
            self.release(t, txn)

    def granted_mode(self, table: str) -> Optional[str]:
        lock = self._locks.get(table)
        return lock.mode if lock and lock.holders else None
