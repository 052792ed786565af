"""Projections (paper §3.1-§3.3): the only physical structure.

* Every table gets at least one *super projection* with all columns (the
  paper dropped C-Store's join indices -- so do we; there is no other way to
  reconstruct full tuples).
* Non-super projections carry a column subset with their own sort order and
  segmentation.
* Prejoin projections denormalize N:1 joins of the anchor table with
  dimension tables at load time.
* Every projection gets a *buddy* (ring-offset segmentation) when K-safety
  K >= 1; replicated projections are their own buddy.

Mirrors ``src/repro/core/projection.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from .encodings import Encoding
from .segmentation import SegmentationSpec
from .types import TableSchema


@dataclasses.dataclass(frozen=True)
class PrejoinSpec:
    """Join the anchor's fact rows with one dimension table at load.

    anchor_key: FK column in the anchor table
    dim_table / dim_key: dimension table and its (unique) join key
    dim_columns: dimension attributes materialized into the projection,
                 stored under 'dimtable.col' names.
    """
    anchor_key: str
    dim_table: str
    dim_key: str
    dim_columns: Tuple[str, ...]


@dataclasses.dataclass(frozen=True)
class ProjectionDef:
    name: str
    anchor: str                          # anchoring table name
    columns: Tuple[str, ...]             # in storage order
    sort_order: Tuple[str, ...]          # prefix of columns to sort by
    segmentation: SegmentationSpec
    encodings: Dict[str, Encoding] = dataclasses.field(default_factory=dict)
    is_super: bool = False
    buddy_of: Optional[str] = None       # name of the primary this buddies
    prejoin: Optional[PrejoinSpec] = None

    def encoding_for(self, col: str) -> Encoding:
        return self.encodings.get(col, Encoding.AUTO)

    def buddy_def(self) -> "ProjectionDef":
        """The K=1 buddy: same columns/sort, ring offset +1 (paper §5.2)."""
        if self.segmentation.replicated:
            return self  # replicas are their own buddies
        seg = dataclasses.replace(self.segmentation,
                                  offset=self.segmentation.offset + 1)
        return dataclasses.replace(self, name=self.name + "_b1",
                                   segmentation=seg, buddy_of=self.name)


def super_projection(schema: TableSchema, sort_order: Tuple[str, ...],
                     seg_columns: Tuple[str, ...],
                     encodings: Optional[Dict[str, Encoding]] = None,
                     n_local_segments: int = 3) -> ProjectionDef:
    cols = schema.column_names()
    assert all(c in cols for c in sort_order)
    seg = SegmentationSpec("hash", tuple(seg_columns),
                           n_local_segments=n_local_segments) \
        if seg_columns else SegmentationSpec("replicated")
    return ProjectionDef(
        name=f"{schema.name}_super", anchor=schema.name, columns=cols,
        sort_order=tuple(sort_order), segmentation=seg,
        encodings=encodings or {}, is_super=True)
