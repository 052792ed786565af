"""The Database Designer (paper §6.3): automatic physical design.

Two sequential phases, as published:
  1. Query optimization -- enumerate candidate projections from workload
     heuristics (predicate columns, group-by columns, aggregate columns,
     join keys), invoke the real optimizer/cost model per query with each
     candidate available, and keep the projections the optimizer actually
     picks.
  2. Storage optimization -- choose encodings *empirically*: encode a data
     sample with every legal scheme and keep the smallest (this is
     encodings.encode(AUTO); the DBD records the choice per column).

Design policies trade query speed against storage/load cost by capping how
many non-super projections are proposed.

Mirrors ``src/repro/planner/designer.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..core.database import VerticaDB
from ..core.encodings import Encoding, encode
from ..core.projection import ProjectionDef, SegmentationSpec
from ..core.types import SQLType
from ..engine.logical import LogicalQuery, as_ir
from . import cost as cost_mod

POLICIES = {"load-optimized": 0, "balanced": 2, "query-optimized": 4}


@dataclasses.dataclass
class DesignReport:
    proposed: List[ProjectionDef]
    encoding_choices: Dict[str, Dict[str, str]]
    per_query: List[Tuple[str, float, float]]   # (desc, before_s, after_s)
    sort_choices: Dict[str, Tuple[str, ...]] = \
        dataclasses.field(default_factory=dict)


SORT_SAMPLE_ROWS = 20_000


def _sort_key_score(sample: Dict[str, np.ndarray],
                    order: Tuple[str, ...], need: Sequence[str],
                    types: Dict[str, SQLType],
                    groupby_sets: Sequence[frozenset]
                    ) -> Tuple[int, float]:
    """Score one candidate sort key (paper §6.3).  Lower is better.

    Primary term: how many workload group-by sets the key covers as a
    sort-order prefix -- those queries aggregate sorted runs in one pass
    instead of rebuilding a hash table.  Secondary term: actual encoded
    bytes of a data sample laid out in that order (the phase-2 storage
    experiment reused as a tie-breaker; better-clustered sort keys
    RLE/delta-compress smaller).
    """
    if not sample or any(c not in sample for c in order):
        return (0, float("inf"))
    idx = np.lexsort(tuple(np.asarray(sample[c])
                           for c in reversed(order)))
    nbytes = 0.0
    for c in need:
        if c not in sample:
            continue
        enc = encode(np.asarray(sample[c])[idx],
                     types.get(c, SQLType.INT))
        nbytes += enc.storage_bytes
    covered = sum(1 for g in groupby_sets if g <= set(order[:len(g)]))
    return (-covered, nbytes)


def _candidates_for_query(db: VerticaDB, q: LogicalQuery,
                          groupby_sets: Sequence[frozenset] = (),
                          sample: Optional[Dict[str, np.ndarray]] = None
                          ) -> List[ProjectionDef]:
    """Heuristic candidate enumeration (paper phase 1)."""
    table = db.catalog.tables[q.table].schema
    need = sorted(q.needed_columns() & set(table.column_names()))
    types = {c.name: c.sql_type for c in table.columns}
    gb_cols = set().union(*groupby_sets) if groupby_sets else set()
    cands = []
    sort_firsts = []
    if q.predicate is not None:
        sort_firsts += sorted(q.predicate.bounds())
    sort_firsts += list(q.group_by)
    sort_firsts += [j.fact_key for j in q.joins]
    seen = set()
    for first in sort_firsts:
        if first in seen or first not in need:
            continue
        seen.add(first)
        rest = [c for c in need if c != first]
        # candidate 2-column sort keys: the second column comes from the
        # workload's group-by sets (falling back to the first remaining
        # column); each is scored against the whole workload
        seconds = [c for c in rest if c in gb_cols] or rest[:1]
        orders = [(first, s) for s in seconds] or [(first,)]
        if sample is not None and len(orders) > 1:
            order = min(orders, key=lambda o: _sort_key_score(
                sample, o, need, types, groupby_sets))
        else:
            order = orders[0]
        seg_cols = (q.joins[0].fact_key,) if q.joins else \
            ((first,) if not q.group_by else q.group_by)
        cands.append(ProjectionDef(
            name=f"{q.table}_dbd_{first}",
            anchor=q.table, columns=tuple([first] + rest),
            sort_order=order,
            segmentation=SegmentationSpec("hash", tuple(
                c for c in seg_cols if c in need) or (first,))))
    return cands


def design(db: VerticaDB, workload: Sequence, *,
           policy: str = "balanced",
           deploy: bool = False) -> DesignReport:
    from .planner import plan_query

    workload = [as_ir(q) for q in workload]
    budget = POLICIES[policy]
    # baseline costs with the current design
    before = []
    for q in workload:
        plan = plan_query(db, q)
        before.append(plan.estimated.total if plan.estimated else 0.0)

    # workload-wide group-by sets + per-table samples drive 2-column
    # sort-key scoring (paper §6.3)
    groupby_sets = [frozenset(q.group_by) for q in workload if q.group_by]
    samples: Dict[str, Dict[str, np.ndarray]] = {}
    for q in workload:
        if q.table not in samples:
            rows = db.read_table(q.table)
            samples[q.table] = {c: np.asarray(v)[:SORT_SAMPLE_ROWS]
                                for c, v in rows.items()}

    # phase 1: propose, deploy tentatively, re-plan, keep what gets used
    proposals: Dict[str, ProjectionDef] = {}
    for q in workload:
        for cand in _candidates_for_query(db, q, groupby_sets,
                                          samples.get(q.table)):
            if cand.name not in proposals \
                    and cand.name not in db.catalog.projections:
                proposals[cand.name] = cand
    chosen: List[ProjectionDef] = []
    per_query = []
    if proposals and budget > 0:
        for cand in list(proposals.values()):
            db.create_projection(cand, populate=True)
        for q, b in zip(workload, before):
            plan = plan_query(db, q)
            a = plan.estimated.total if plan.estimated else 0.0
            per_query.append((repr(q.table) + "/" +
                              (",".join(q.group_by) or "scan"), b, a))
            picked = db.catalog.projections.get(plan.projection)
            if picked is not None and picked.name in proposals and \
                    picked not in chosen:
                chosen.append(picked)
        chosen = chosen[:budget]
        # tear down unused proposals (and everything if not deploying)
        for cand in list(proposals.values()):
            keep = deploy and cand in chosen
            if not keep:
                _drop_projection(db, cand.name)
                _drop_projection(db, cand.name + "_b1")
    else:
        for q, b in zip(workload, before):
            per_query.append((repr(q.table), b, b))

    # phase 2: empirical encoding choice on a sample (AUTO == the
    # experiment; we record what it picked)
    enc_report: Dict[str, Dict[str, str]] = {}
    for proj in ([p for p in chosen] if deploy else
                 list(db.catalog.projections.values())):
        choice = {}
        rows = db.read_projection(proj.name) if deploy else \
            db.read_table(proj.anchor)
        for c in proj.columns:
            if c not in rows or len(rows[c]) == 0:
                continue
            sample = rows[c][:100_000]
            enc = encode(np.asarray(sample), SQLType.INT)
            choice[c] = enc.encoding.value
        enc_report[proj.name] = choice
    return DesignReport(chosen, enc_report, per_query,
                        {p.name: p.sort_order
                         for p in proposals.values()})


def _drop_projection(db: VerticaDB, name: str):
    if name not in db.catalog.projections:
        return
    del db.catalog.projections[name]
    for node in db.nodes:
        node.stores.pop(name, None)
