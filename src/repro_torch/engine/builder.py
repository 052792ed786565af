"""Fluent query builder: the session-level front-end over the logical IR.

    out = (db.query("lineitem")
             .where(col("l_shipdate") > 60)
             .join("orders", on=("l_orderkey", "o_orderkey"),
                   cols=("o_custkey",))
             .join("region", on=("o_custkey", "r_custkey"),
                   cols=("r_name",))
             .group_by("o_custkey", "r_name")
             .agg(revenue=("l_extprice", "sum"), n=("*", "count"))
             .having(col("revenue") > 0)
             .order_by("-revenue")
             .limit(10)
             .collect())

Each method returns a *new* builder (copy-on-write), so a partially built
pipeline can be reused as a template.  ``to_ir()`` lowers to the canonical
``LogicalQuery`` (engine/logical.py); ``collect()`` executes and returns
the result columns, stashing the run's ``ExecStats`` on ``.stats``;
``execute()`` returns ``(results, stats)`` like engine.execute.

Mirrors ``src/repro/engine/builder.py``: a verbatim copy, so the port imports
nothing of the reference package.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from .expr import Expr
from .logical import AGG_KINDS, LogicalJoin, LogicalQuery


def _parse_on(on) -> Tuple[str, str]:
    """Accept on="key" (same name both sides), on="fact=dim", or
    on=("fact", "dim")."""
    if isinstance(on, str):
        if "=" in on:
            f, d = on.split("=", 1)
            return f.strip(), d.strip()
        return on, on
    f, d = on
    return f, d


def _parse_order(cols, desc: bool) -> Tuple[Tuple[str, bool], ...]:
    out = []
    for c in cols:
        if c.startswith("-"):
            out.append((c[1:], True))
        else:
            out.append((c, desc))
    return tuple(out)


@dataclasses.dataclass(eq=False)
class QueryBuilder:
    db: object
    table: str
    _columns: Tuple[str, ...] = ()
    _derived: Tuple[Tuple[str, Expr], ...] = ()
    _predicate: Optional[Expr] = None
    _joins: Tuple[LogicalJoin, ...] = ()
    _group_by: Tuple[str, ...] = ()
    _aggs: Tuple[Tuple[str, str, str], ...] = ()
    _having: Optional[Expr] = None
    _order_by: Tuple[Tuple[str, bool], ...] = ()
    _limit: Optional[int] = None
    stats: object = None               # ExecStats of the last collect()

    def _with(self, **kw) -> "QueryBuilder":
        return dataclasses.replace(self, stats=None, **kw)

    # -------------------------------------------------------- clauses --

    def select(self, *cols: str, **derived: Expr) -> "QueryBuilder":
        """Output columns; keyword args define derived expressions
        (``margin=col("price") - col("cost")``) usable in later clauses."""
        return self._with(
            _columns=self._columns + cols,
            _derived=self._derived + tuple(derived.items()))

    def where(self, predicate: Expr) -> "QueryBuilder":
        """Fact-side filter; repeated calls AND together."""
        p = predicate if self._predicate is None \
            else self._predicate & predicate
        return self._with(_predicate=p)

    def join(self, dim_table: str, on, cols: Tuple[str, ...] = (),
             where: Optional[Expr] = None,
             how: str = "inner") -> "QueryBuilder":
        """Join a dimension table.  ``on`` is the key pair (see _parse_on);
        ``cols`` are the dimension columns carried into the output;
        ``where`` filters the dimension before the join (and arms SIP)."""
        fact_key, dim_key = _parse_on(on)
        cols = (cols,) if isinstance(cols, str) else tuple(cols)
        spec = LogicalJoin(dim_table, fact_key, dim_key, cols,
                           where, how)
        return self._with(_joins=self._joins + (spec,))

    def group_by(self, *cols: str) -> "QueryBuilder":
        return self._with(_group_by=self._group_by + cols)

    def agg(self, **named) -> "QueryBuilder":
        """Named aggregates: ``total=("price", "sum"), n=("*", "count")``.
        A bare column string means count: ``n="*"``."""
        specs = []
        for out, spec in named.items():
            if isinstance(spec, str):
                spec = (spec, "count")
            c, kind = spec
            if kind not in AGG_KINDS:
                raise ValueError(f"unknown aggregate {kind!r} "
                                 f"(one of {AGG_KINDS})")
            specs.append((out, c, kind))
        return self._with(_aggs=self._aggs + tuple(specs))

    def having(self, predicate: Expr) -> "QueryBuilder":
        h = predicate if self._having is None \
            else self._having & predicate
        return self._with(_having=h)

    def order_by(self, *cols: str, desc: bool = False) -> "QueryBuilder":
        """Sort keys in major-to-minor order; prefix "-" for descending
        per key (or desc=True for all)."""
        return self._with(_order_by=self._order_by
                          + _parse_order(cols, desc))

    def limit(self, n: int) -> "QueryBuilder":
        return self._with(_limit=int(n))

    # ------------------------------------------------------- lowering --

    def to_ir(self) -> LogicalQuery:
        return LogicalQuery(
            table=self.table, columns=self._columns,
            derived=self._derived, predicate=self._predicate,
            joins=self._joins, group_by=self._group_by, aggs=self._aggs,
            having=self._having, order_by=self._order_by,
            limit=self._limit).validate()

    def explain(self) -> str:
        """Logical tree plus the planner's physical choices."""
        from ..planner.planner import plan_query
        ir = self.to_ir()
        plan = plan_query(self.db, ir)
        return ir.explain() + "\n-- physical --\n" + "\n".join(plan.explain)

    # ------------------------------------------------------ execution --

    def execute(self, *, as_of: Optional[int] = None):
        from .pipeline import execute
        return execute(self.db, self.to_ir(), as_of=as_of)

    def collect(self, *, as_of: Optional[int] = None
                ) -> Dict[str, np.ndarray]:
        out, stats = self.execute(as_of=as_of)
        self.stats = stats
        return out
