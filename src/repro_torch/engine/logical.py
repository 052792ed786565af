"""Logical-plan IR: the relational front-end's single source of truth.

The paper's interface claim (§1, §6) is that Vertica looks like a classical
relational database while executing on a columnar, compressed, distributed
engine.  This module is that interface layer for the repro: a small
relational algebra

    Scan -> Filter -> Join* -> Project -> Aggregate[HAVING] -> Sort -> Limit

with two equivalent representations:

* **Node tree** (`Scan`, `Filter`, `Join`, `Project`, `Aggregate`, `Sort`,
  `Limit`): the syntax-level plan, one node per operator, composable by
  hand or by the fluent builder (engine/builder.py).  `lower()` folds a
  tree into the canonical form below, merging stacked Filters conjunctively
  and classifying a post-Aggregate Filter as HAVING.
* **`LogicalQuery`**: the canonical flat form every downstream layer
  consumes -- the planner (planner/planner.py) chooses projection, join
  order/strategy, SIP and groupby algorithm from it; the executor
  (engine/pipeline.py, engine/executor.py) runs it; and its
  ``signature()`` is the *hashable canonical key* the plan cache memoizes
  fused programs under, so "same query shape" is defined once, here.

Generalizations over the legacy ``Query`` dataclass (kept as a shim in
engine/pipeline.py): a *list* of join specs instead of at most one, a
*tuple* of group-by columns instead of at most one, derived-expression
projections (``revenue = price * qty``), HAVING, and multi-key ORDER BY.

Mirrors ``src/repro/engine/logical.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from .expr import Expr

AGG_KINDS = ("sum", "count", "min", "max", "avg")


def _sig(e: Optional[Expr]) -> str:
    return "" if e is None else e.signature()


@dataclasses.dataclass(frozen=True, eq=False)
class LogicalJoin:
    """One N:1 (fact -> dimension) join edge.

    ``fact_key`` names a column of the probe side *at the point the join
    runs* -- for snowflake chains it may be a column emitted by an earlier
    join rather than a physical fact column."""
    dim_table: str
    fact_key: str
    dim_key: str
    dim_columns: Tuple[str, ...] = ()
    dim_predicate: Optional[Expr] = None
    how: str = "inner"

    def signature(self) -> tuple:
        return ("join", self.dim_table, self.fact_key, self.dim_key,
                tuple(self.dim_columns), _sig(self.dim_predicate), self.how)


@dataclasses.dataclass(frozen=True, eq=False)
class LogicalQuery:
    """Canonical flat IR.  Field order mirrors execution order."""
    table: str
    columns: Tuple[str, ...] = ()
    derived: Tuple[Tuple[str, Expr], ...] = ()      # (name, expr)
    predicate: Optional[Expr] = None                # fact-side WHERE
    joins: Tuple[LogicalJoin, ...] = ()
    group_by: Tuple[str, ...] = ()
    aggs: Tuple[Tuple[str, str, str], ...] = ()     # (out, col|"*", kind)
    having: Optional[Expr] = None                   # over agg outputs
    order_by: Tuple[Tuple[str, bool], ...] = ()     # (col, descending)
    limit: Optional[int] = None

    # ------------------------------------------------------------ info --

    def validate(self) -> "LogicalQuery":
        agg_out = {a[0] for a in self.aggs}
        derived_names = {n for n, _ in self.derived}
        for out, c, kind in self.aggs:
            if kind not in AGG_KINDS:
                raise ValueError(f"unknown aggregate {kind!r}")
            if c == "*" and kind != "count":
                raise ValueError(f"{kind}(*) is not defined; "
                                 "only count(*)")
        for j in self.joins:
            if j.how not in ("inner", "left"):
                raise ValueError(f"unsupported join type {j.how!r}")
        if self.having is not None:
            bad = self.having.columns() - agg_out - set(self.group_by) \
                - {"group_count"}
            if bad:
                raise ValueError(
                    f"HAVING references {sorted(bad)}, not produced by "
                    f"group keys {self.group_by} or aggs {sorted(agg_out)}")
        if (self.aggs or self.group_by) and self.columns:
            extra = set(self.columns) - set(self.group_by) - agg_out \
                - derived_names
            if extra:
                raise ValueError(
                    f"selected columns {sorted(extra)} are neither group "
                    "keys nor aggregates")
        if self.order_by:
            # sort keys must exist in the output row set (statically
            # checkable except for select-all queries)
            if self.aggs or self.group_by:
                avail = set(self.group_by) | agg_out | {"group_count"}
            elif self.columns or self.derived:
                avail = set(self.columns) | derived_names
            else:
                avail = None          # select * : resolved at runtime
            if avail is not None:
                bad = [c for c, _ in self.order_by if c not in avail]
                if bad:
                    raise ValueError(
                        f"ORDER BY {bad} not in the output columns "
                        f"{sorted(avail)}")
        return self

    def needed_columns(self) -> set:
        """Input columns required before aggregation (fact or dim side;
        the planner subtracts join-provided and derived names to get the
        scan set)."""
        derived_names = {n for n, _ in self.derived}
        agg_out = {a[0] for a in self.aggs}
        need = set(self.columns) - derived_names - agg_out
        for _, e in self.derived:
            need |= e.columns()
        if self.predicate is not None:
            need |= self.predicate.columns()
        need |= set(self.group_by) - derived_names
        for _, c, kind in self.aggs:
            if kind != "count" and c != "*" and c not in derived_names:
                need.add(c)
        for j in self.joins:
            need.add(j.fact_key)
        for c, _ in self.order_by:
            if c not in agg_out and c not in derived_names \
                    and c != "group_count":
                need.add(c)
        return need

    def signature(self) -> tuple:
        """Canonical hashable identity of the full query, host-side
        shaping included."""
        return ("lq", self.table, tuple(self.columns),
                tuple((n, e.signature()) for n, e in self.derived),
                _sig(self.predicate),
                tuple(j.signature() for j in self.joins),
                tuple(self.group_by), tuple(self.aggs),
                _sig(self.having), tuple(self.order_by), self.limit)

    def scan_predicate(self, proj_columns) -> Optional[Expr]:
        """The WHERE predicate iff it is fully evaluable on scanned fact
        columns (push-down); None means it defers until after joins and
        derived projections.  Single definition keeps the fused executor
        and the general pipeline (and the plan-cache signature's
        determinism argument) in sync."""
        if self.predicate is not None \
                and self.predicate.columns() <= set(proj_columns):
            return self.predicate
        return None

    def scan_columns(self, proj) -> set:
        """Physical columns the scan must produce from a projection.
        Never empty for an aggregate query: count(*) with no predicate
        still needs one column to carry row validity -- the sort leader,
        whose RLE encoding makes it the cheapest to decode."""
        need = self.needed_columns() & set(proj.columns)
        if not need and (self.aggs or self.group_by):
            need = {proj.sort_order[0] if proj.sort_order
                    else proj.columns[0]}
        return need

    def exec_signature(self) -> tuple:
        """Identity of the *device program* only: HAVING / ORDER BY /
        LIMIT (and the output column list) are applied host-side in
        pipeline._finalize and never enter the traced program, so two
        queries differing only there share one fused executable.  This is
        the plan-cache key (engine/executor.py adds the physical choices
        on top)."""
        return ("lq-exec", self.table,
                tuple((n, e.signature()) for n, e in self.derived),
                _sig(self.predicate),
                tuple(j.signature() for j in self.joins),
                tuple(self.group_by), tuple(self.aggs))

    # ------------------------------------------------------- tree view --

    def to_tree(self) -> "Node":
        node: Node = Scan(self.table, tuple(sorted(self.needed_columns())))
        if self.predicate is not None:
            node = Filter(node, self.predicate)
        for j in self.joins:
            node = Join(node, j)
        if self.derived or (self.columns and not self.aggs
                            and not self.group_by):
            node = Project(node, self.columns, self.derived)
        if self.aggs or self.group_by:
            node = Aggregate(node, self.group_by, self.aggs)
            if self.having is not None:
                node = Filter(node, self.having)
        if self.order_by:
            node = Sort(node, self.order_by)
        if self.limit is not None:
            node = Limit(node, self.limit)
        return node

    def explain(self) -> str:
        lines = []
        node: Optional[Node] = self.to_tree()
        depth = 0
        chain = []
        while node is not None:
            chain.append(node)
            node = getattr(node, "child", None)
        for node in reversed(chain):
            lines.append("  " * depth + node.describe())
            depth += 1
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Node tree (syntax level)
# ---------------------------------------------------------------------------

class Node:
    """Base of the syntax tree; every node but Scan holds a ``child``."""

    def describe(self) -> str:
        return type(self).__name__


@dataclasses.dataclass(eq=False)
class Scan(Node):
    table: str
    columns: Tuple[str, ...] = ()
    child: None = None

    def describe(self):
        return f"Scan {self.table} {list(self.columns)}"


@dataclasses.dataclass(eq=False)
class Filter(Node):
    child: Node
    predicate: Expr

    def describe(self):
        return f"Filter {self.predicate.signature()}"


@dataclasses.dataclass(eq=False)
class Join(Node):
    child: Node
    spec: LogicalJoin

    def describe(self):
        s = self.spec
        pred = f" where {_sig(s.dim_predicate)}" if s.dim_predicate \
            is not None else ""
        return (f"Join {s.how} {s.dim_table} on "
                f"{s.fact_key}={s.dim_key} +{list(s.dim_columns)}{pred}")


@dataclasses.dataclass(eq=False)
class Project(Node):
    child: Node
    columns: Tuple[str, ...] = ()
    derived: Tuple[Tuple[str, Expr], ...] = ()

    def describe(self):
        d = [f"{n}={e.signature()}" for n, e in self.derived]
        return f"Project {list(self.columns) + d}"


@dataclasses.dataclass(eq=False)
class Aggregate(Node):
    child: Node
    group_by: Tuple[str, ...] = ()
    aggs: Tuple[Tuple[str, str, str], ...] = ()

    def describe(self):
        a = [f"{o}={k}({c})" for o, c, k in self.aggs]
        return f"Aggregate by {list(self.group_by)} {a}"


@dataclasses.dataclass(eq=False)
class Sort(Node):
    child: Node
    keys: Tuple[Tuple[str, bool], ...]

    def describe(self):
        return "Sort " + ", ".join(f"{c}{' desc' if d else ''}"
                                   for c, d in self.keys)


@dataclasses.dataclass(eq=False)
class Limit(Node):
    child: Node
    n: int

    def describe(self):
        return f"Limit {self.n}"


def lower(root: Node) -> LogicalQuery:
    """Fold a node tree into the canonical LogicalQuery.  Stacked Filters
    merge conjunctively; a Filter above an Aggregate becomes HAVING;
    operator order is validated (joins/filters below aggregation, sort and
    limit above it)."""
    chain = []
    node: Optional[Node] = root
    while node is not None:
        chain.append(node)
        node = node.child
    chain.reverse()                       # Scan first
    if not chain or not isinstance(chain[0], Scan):
        raise ValueError("plan must be rooted at a Scan")
    scan = chain[0]
    q = dict(table=scan.table, columns=(), derived=(), predicate=None,
             joins=(), group_by=(), aggs=(), having=None, order_by=(),
             limit=None)
    seen_agg = False
    for node in chain[1:]:
        if isinstance(node, Filter):
            if seen_agg:
                q["having"] = node.predicate if q["having"] is None \
                    else q["having"] & node.predicate
            else:
                q["predicate"] = node.predicate if q["predicate"] is None \
                    else q["predicate"] & node.predicate
        elif isinstance(node, Join):
            if seen_agg:
                raise ValueError("Join above Aggregate is unsupported")
            q["joins"] = q["joins"] + (node.spec,)
        elif isinstance(node, Project):
            q["columns"] = tuple(node.columns)
            q["derived"] = q["derived"] + tuple(node.derived)
        elif isinstance(node, Aggregate):
            if seen_agg:
                raise ValueError("only one Aggregate per query")
            seen_agg = True
            q["group_by"] = tuple(node.group_by)
            q["aggs"] = tuple(node.aggs)
        elif isinstance(node, Sort):
            q["order_by"] = tuple(node.keys)
        elif isinstance(node, Limit):
            q["limit"] = node.n
        else:
            raise ValueError(f"unexpected node {type(node).__name__}")
    return LogicalQuery(**q).validate()


def as_ir(q) -> LogicalQuery:
    """Accept any front-end shape: LogicalQuery (identity), a node tree,
    or anything exposing ``to_ir()`` (the legacy Query shim, the fluent
    builder)."""
    if isinstance(q, LogicalQuery):
        return q
    if isinstance(q, Node):
        return lower(q)
    to_ir = getattr(q, "to_ir", None)
    if to_ir is not None:
        return to_ir()
    raise TypeError(f"not a logical plan: {type(q).__name__}")
