"""The query planner (paper §6.2, a compact V2Opt), over the logical IR.

Physical-property driven: for each candidate projection we check
  * column coverage (can it answer the query at all),
  * sort-order match against predicate / group-by columns (pruning and
    pipelined aggregation),
  * segmentation vs join keys (co-located vs broadcast vs resegment),
then cost the survivors with the compression-aware model and keep the
cheapest.  Each join in the IR's join list gets its own distribution
strategy and SIP decision; composite group-by keys get per-column domain
estimates (from container SMAs) that drive both the dense/sort algorithm
choice and the executor's static key packing.

Mirrors ``src/repro/planner/planner.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core.database import VerticaDB
from ..engine.logical import LogicalQuery, as_ir
from ..core.encodings import Encoding
from . import cost as cost_mod


@dataclasses.dataclass
class PhysicalPlan:
    projection: str
    sources: List[Tuple[int, str]]          # (host node, projection) pairs
    groupby_algorithm: str = "sort"
    scalar_rle: bool = False           # COUNT on RLE runs, zero decode
    join_strategy: str = ""            # "; "-joined per-join strategies
    join_strategies: Tuple[str, ...] = ()
    # per-join exchange operator for the segmented executor
    # (engine/segmented.py): "local" | "broadcast" | "resegment"
    join_exchanges: Tuple[str, ...] = ()
    use_sip: bool = False              # any join armed with SIP
    sip_joins: Tuple[bool, ...] = ()   # per-join SIP decision
    # per-group-column dense domain estimates (None = unknown); the
    # executor packs composite keys with these as static radices
    key_domains: Optional[Tuple[Optional[int], ...]] = None
    dense_domain_limit: int = 1 << 20
    max_groups: int = 1 << 16
    estimated: Optional[cost_mod.CostEstimate] = None
    explain: List[str] = dataclasses.field(default_factory=list)


def _fact_columns(q: LogicalQuery) -> set:
    """Columns the fact-side projection must supply (join output columns
    come from the dimension build sides, derived columns are computed)."""
    need = q.needed_columns()
    for j in q.joins:
        need -= set(j.dim_columns) | {j.dim_key}
    need -= {n for n, _ in q.derived}
    return need


def candidate_projections(db: VerticaDB, q: LogicalQuery):
    need = _fact_columns(q)
    out = []
    for p in db.catalog.projections_of(q.table):
        if p.buddy_of is not None:
            continue
        if need <= set(p.columns):
            out.append(p)
    return out


def plan_query(db: VerticaDB, q) -> PhysicalPlan:
    q = as_ir(q)
    cands = candidate_projections(db, q)
    if not cands:
        raise ValueError(f"no projection covers {sorted(_fact_columns(q))}")
    need = _fact_columns(q)
    best = None
    for p in cands:
        est = cost_mod.scan_cost(db, p, q.predicate, need)
        bonus = 1.0
        # sort-order match: leading sort column in the predicate => pruning
        # actually bites; on the leading group-by key => pipelined agg
        bounds = q.predicate.bounds() if q.predicate is not None else {}
        if p.sort_order and p.sort_order[0] in bounds:
            bonus *= 0.5
        if q.group_by and p.sort_order \
                and p.sort_order[0] == q.group_by[0]:
            bonus *= 0.8
        score = est.total * bonus
        if best is None or score < best[0]:
            best = (score, p, est)
    _, proj, est = best

    plan = PhysicalPlan(projection=proj.name, sources=[], estimated=est)
    plan.explain.append(
        f"projection {proj.name} (sort {proj.sort_order}, "
        f"~{est.bytes_scanned/1e6:.2f}MB scanned, est {est.total*1e3:.3f}ms)")

    # source routing (buddy failover; one host may serve two segments).
    # ``serving()`` excludes recovering shards: a rejoined node receives
    # commits but must not serve scans until recover_node() completes
    if proj.segmentation.replicated:
        first_up = next((n.id for n in db.nodes if n.serving()), None)
        if first_up is None:
            from ..core.database import AvailabilityError
            raise AvailabilityError(f"no serving replica of {proj.name}")
        plan.sources = [(first_up, proj.name)]
    else:
        owners = db.segment_owners(proj)
        for seg_node, owner_proj in owners.items():
            host = seg_node
            if owner_proj != proj.name:
                host = (seg_node + db.catalog.projections[
                    owner_proj].segmentation.offset) % db.catalog.n_nodes
            if (host, owner_proj) not in plan.sources:
                plan.sources.append((host, owner_proj))
        n_buddy = sum(1 for _, o in plan.sources
                      if db.catalog.projections[o].buddy_of is not None)
        if n_buddy:
            plan.explain.append(
                f"failover routing: {n_buddy}/{len(plan.sources)} "
                f"source(s) served by buddy projections (K-safety)")

    # join strategy + SIP + exchange op, one decision per join edge.  The
    # probe side's *placement* (which columns its rows are currently
    # hash-distributed by) starts at the projection's segmentation and is
    # rewritten by every resegment, so a later join's co-location claim is
    # judged against where the rows actually are, not where storage put
    # them (paper §6.2 'favor co-located joins where possible').
    placement = None if proj.segmentation.replicated \
        else tuple(proj.segmentation.columns)
    strategies, sips, exchanges = [], [], []
    for spec in q.joins:
        dim_rows = _dim_row_estimate(db, db.catalog.super_of(
            spec.dim_table))
        strat, net_s = cost_mod.join_distribution(
            db, proj, spec.fact_key, spec.dim_table, dim_rows,
            dim_key=spec.dim_key, placement=placement)
        if strat.startswith("co-located"):
            exch = "local"
        elif strat == "resegment":
            if placement == (spec.fact_key,):
                # an earlier resegment already placed the probe side by
                # this key; the build side is placed by hash(dim_key)
                # regardless of its stored segmentation, so the join is
                # local now -- re-exchanging would be pure waste
                exch = "local"
                strat = "co-located (placement)"
                net_s = 0.0
            elif spec.fact_key in proj.columns:
                exch = "resegment"
                placement = (spec.fact_key,)
            else:
                # snowflake key: it only materializes after an earlier
                # join, so the scan cannot compute its hash destination --
                # replicate the build side instead
                exch = "broadcast"
                strat = "broadcast (snowflake key)"
        else:
            exch = "broadcast"
        strategies.append(strat)
        exchanges.append(exch)
        est.net_s += net_s
        # SIP only pays when the build side actually filters (the paper's
        # predictability lesson: drop special cases that sometimes lose)
        # and the probe key is a physical fact column the scan can see --
        # snowflake keys materialize only after an earlier join.
        sips.append(spec.dim_predicate is not None
                    and spec.fact_key in proj.columns)
        plan.explain.append(
            f"join {spec.dim_table} on {spec.fact_key}: {strat} "
            f"(exchange {exch}), SIP={sips[-1]}")
    plan.join_strategies = tuple(strategies)
    plan.join_strategy = "; ".join(strategies)
    plan.join_exchanges = tuple(exchanges)
    plan.sip_joins = tuple(sips)
    plan.use_sip = any(sips)

    # scalar COUNT with an EXACT integer interval on the RLE sort leader:
    # run-level math only (bounds() is pruning-conservative; counting needs
    # exact_int_interval -- see engine/expr.py)
    if not q.group_by and q.aggs and not q.joins and not q.derived \
            and all(a[2] == "count" for a in q.aggs):
        from ..engine.expr import exact_int_interval
        leader = proj.sort_order[0] if proj.sort_order else None
        iv = exact_int_interval(q.predicate) \
            if q.predicate is not None else (leader, None, None)
        if iv is not None and iv[0] == leader \
                and _is_rle_sorted(db, proj, leader):
            plan.scalar_rle = True
            plan.explain.append("scalar COUNT on RLE runs (no decode)")

    # groupby algorithm: dense when the packed key domain (product of
    # per-column SMA domains) is small, else sort-based; RLE-direct for a
    # single already-sorted RLE key with count-only aggregates
    if q.group_by:
        derived_names = {n for n, _ in q.derived}
        doms: List[Optional[int]] = []
        for g in q.group_by:
            if g in derived_names:
                doms.append(None)
                continue
            src = proj
            for spec in q.joins:
                if g in spec.dim_columns:
                    # a dimension attribute: its domain comes from the dim
                    # projection's SMAs (the fact side never stores it)
                    src = db.catalog.super_of(spec.dim_table)
                    break
            doms.append(_domain_estimate(db, src, g))
        plan.key_domains = tuple(doms)
        if all(d is not None for d in doms):
            total = 1
            for d in doms:
                total *= d
            plan.groupby_algorithm = (
                "dense" if 0 <= total <= plan.dense_domain_limit
                else "sort")
        else:
            total = None
            plan.groupby_algorithm = "sort"
        if len(q.group_by) == 1 \
                and _is_rle_sorted(db, proj, q.group_by[0]) \
                and not q.predicate and not q.joins \
                and all(a[2] == "count" for a in q.aggs):
            plan.groupby_algorithm = "rle"
        plan.explain.append(
            f"groupby {plan.groupby_algorithm} "
            f"(domains {doms} -> {total})")
    return plan


def _dim_row_estimate(db: VerticaDB, proj) -> int:
    """Build-side cardinality from store metadata (no decode; delete
    vectors ignored -- an overcount is fine for a strategy decision)."""
    up = [n for n in db.nodes if n.serving()]
    if proj.segmentation.replicated:
        up = up[:1]
    return sum(st.ros_rows() + st.wos.n_rows
               for n in up for st in [n.stores[proj.name]])


def _domain_estimate(db: VerticaDB, proj, col: str) -> Optional[int]:
    lo = hi = None
    for node in db.nodes:
        if not node.serving():
            continue
        for c in node.stores[proj.name].containers:
            if col not in c.smas or c.n_rows == 0:
                continue
            cmin, cmax = int(c.smas[col].container_min()), \
                int(c.smas[col].container_max())
            lo = cmin if lo is None else min(lo, cmin)
            hi = cmax if hi is None else max(hi, cmax)
    if lo is None:
        return None
    if lo < 0:
        return None
    return hi + 1


def _is_rle_sorted(db: VerticaDB, proj, col: str) -> bool:
    if not proj.sort_order or proj.sort_order[0] != col:
        return False
    for node in db.nodes:
        if not node.serving():
            continue
        for c in node.stores[proj.name].containers:
            if c.columns[col].encoding != Encoding.RLE:
                return False
    return True
