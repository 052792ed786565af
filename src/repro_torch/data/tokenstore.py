"""Columnar token store: the training corpus as a Vertica projection.

Integration story (DESIGN.md §3): training data is a table
(doc_id, pos, token) with a super projection sorted by (doc_id, pos) and
segmented by HASH(doc_id) across the 'data' mesh axis, so

  * bulk ingest goes through WOS -> tuple mover (loading never blocks
    reading: I-lock semantics),
  * a *data epoch* pins an exactly-reproducible training stream (MVCC
    snapshot: re-reading epoch E yields identical batches after any amount
    of later ingest -- this is how restarts resume deterministically),
  * K-safe buddies + elastic rebalance come for free when data-parallel
    ranks fail or the cluster resizes,
  * the (doc_id, pos) sort makes 'token' delta/RLE-compressible and makes
    sequence reconstruction a positional read, not a shuffle.

Mirrors ``src/repro/data/tokenstore.py`` verbatim on the port's
``VerticaDB``, plus its ``device`` (CUDA unless the caller asks for the
CPU): the batches are host arrays, as the reference's are, decoded from
the same containers, so both packages give identical batches.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np

from ..core import (ColumnDef, SQLType, TableSchema, VerticaDB)


@dataclasses.dataclass
class TokenStore:
    db: VerticaDB
    table: str = "corpus"
    doc_len: int = 0

    @staticmethod
    def create(n_nodes: int = 4, *, block_rows: int = 4096,
               k_safety: int = 1, device="cuda") -> "TokenStore":
        db = VerticaDB(n_nodes=n_nodes, k_safety=k_safety,
                       block_rows=block_rows, device=device)
        schema = TableSchema("corpus", (
            ColumnDef("doc_id"), ColumnDef("pos"), ColumnDef("token")))
        db.create_table(schema, sort_order=("doc_id", "pos"),
                        segment_by=("doc_id",))
        return TokenStore(db)

    def ingest(self, rows: Dict[str, np.ndarray], *,
               direct_to_ros: bool = True) -> int:
        """Bulk load a batch of documents; returns the commit (data) epoch."""
        t = self.db.begin(direct_to_ros=direct_to_ros)
        self.db.insert(t, self.table, rows)
        epoch = self.db.commit(t)
        self.db.run_tuple_mover()
        if self.doc_len == 0:
            self.doc_len = int(rows["pos"].max()) + 1
        return epoch

    def n_tokens(self, as_of: Optional[int] = None) -> int:
        return len(self.db.read_table(self.table, as_of=as_of)["token"])

    def sequences(self, seq_len: int, *, as_of: Optional[int] = None
                  ) -> np.ndarray:
        """Materialize (n_seqs, seq_len) token matrix at a data epoch.

        Reads the projection in (doc_id, pos) order -- a positional
        reconstruction, no shuffle -- then packs documents into fixed
        training sequences."""
        rows = self.db.read_table(self.table, as_of=as_of)
        order = np.lexsort((rows["pos"], rows["doc_id"]))
        tokens = rows["token"][order]
        n = (len(tokens) // seq_len) * seq_len
        return tokens[:n].reshape(-1, seq_len)

    def batches(self, batch_size: int, seq_len: int, *,
                as_of: Optional[int] = None, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        """Deterministic epoch-pinned batch stream: (tokens, labels)."""
        seqs = self.sequences(seq_len + 1, as_of=as_of)
        rng = np.random.default_rng(seed)
        idx = rng.permutation(len(seqs))
        for i in range(0, len(idx) - batch_size + 1, batch_size):
            take = seqs[idx[i: i + batch_size]]
            yield {"tokens": take[:, :-1].astype(np.int32),
                   "labels": take[:, 1:].astype(np.int32)}

    def shard_batches(self, rank: int, world: int, batch_size: int,
                      seq_len: int, **kw) -> Iterator[Dict[str, np.ndarray]]:
        """Per-data-parallel-rank stream: rank r takes every w-th batch
        (segment-aligned sharding would read only local segments on a real
        cluster; the simulation keeps the global-stream semantics)."""
        for i, b in enumerate(self.batches(batch_size, seq_len, **kw)):
            if i % world == rank:
                yield b

    def storage_stats(self) -> Dict[str, float]:
        return self.db.storage_report()[f"{self.table}_super"]
