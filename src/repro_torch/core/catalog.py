"""Metadata catalog (paper §5.3).

'Unlike other databases, the catalog is not stored in database tables' --
it is a memory-resident structure with its own transactional persistence.
Here: plain dataclasses + atomic pickle-to-temp-then-rename, version-stamped
by epoch.

Mirrors ``src/repro/core/catalog.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import tempfile
from typing import Dict, Optional, Tuple

from .projection import ProjectionDef
from .types import TableSchema


@dataclasses.dataclass
class TableEntry:
    schema: TableSchema
    partition_expr: Optional[Tuple[str, str]] = None  # (column, expr name)


@dataclasses.dataclass
class Catalog:
    tables: Dict[str, TableEntry] = dataclasses.field(default_factory=dict)
    projections: Dict[str, ProjectionDef] = dataclasses.field(
        default_factory=dict)
    n_nodes: int = 1
    k_safety: int = 1
    version_epoch: int = 0

    def add_table(self, schema: TableSchema,
                  partition_expr: Optional[Tuple[str, str]] = None):
        if schema.name in self.tables:
            raise KeyError(f"table {schema.name!r} exists")
        self.tables[schema.name] = TableEntry(schema, partition_expr)

    def add_projection(self, proj: ProjectionDef):
        if proj.name in self.projections:
            raise KeyError(f"projection {proj.name!r} exists")
        if proj.anchor not in self.tables:
            raise KeyError(f"anchor table {proj.anchor!r} missing")
        self.projections[proj.name] = proj

    def projections_of(self, table: str):
        return [p for p in self.projections.values() if p.anchor == table]

    def super_of(self, table: str) -> ProjectionDef:
        for p in self.projections.values():
            if p.anchor == table and p.is_super and p.buddy_of is None:
                return p
        raise KeyError(f"no super projection for {table!r}")

    # -- persistence ("own mechanism", transactional via atomic rename) --

    def save(self, path: str, epoch: int):
        self.version_epoch = epoch
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
        with os.fdopen(fd, "wb") as f:
            pickle.dump(self, f)
        os.replace(tmp, path)

    @staticmethod
    def load(path: str) -> "Catalog":
        with open(path, "rb") as f:
            return pickle.load(f)
