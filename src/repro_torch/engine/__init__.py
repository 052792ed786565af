"""Execution engine on torch: the fluent builder, logical IR, operators,
the cached fused executor, the single-node pipeline and the segmented
executor.  Mirrors ``src/repro/engine/__init__.py``, less the serving
layer (not ported yet)."""
from .builder import QueryBuilder
from .executor import PLAN_CACHE, PlanCache
from .expr import Col, Expr, Lit, col, lit
from .logical import (Aggregate, Filter, Join, Limit, LogicalJoin,
                      LogicalQuery, Project, Scan, Sort, as_ir, lower)
from .pipeline import ExecStats, JoinSpec, Query, execute
from .segmented import execute_segmented

__all__ = ["Aggregate", "Col", "ExecStats", "Expr", "Filter", "Join",
           "JoinSpec", "Limit", "Lit", "LogicalJoin", "LogicalQuery",
           "PLAN_CACHE", "PlanCache", "Project", "Query", "QueryBuilder",
           "Scan", "Sort", "as_ir", "col", "execute", "execute_segmented",
           "lit", "lower"]
