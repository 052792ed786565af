"""Execution engine on torch: the fluent builder, logical IR, operators,
the cached fused executor and the single-node pipeline.  Mirrors
``src/repro/engine/__init__.py``, less the segmented and serving
executors and the deprecated Query/JoinSpec shims (not ported yet)."""
from .builder import QueryBuilder
from .executor import PLAN_CACHE, PlanCache
from .expr import Col, Expr, Lit, col, lit
from .logical import (Aggregate, Filter, Join, Limit, LogicalJoin,
                      LogicalQuery, Project, Scan, Sort, as_ir, lower)
from .pipeline import ExecStats, execute

__all__ = ["Aggregate", "Col", "ExecStats", "Expr", "Filter", "Join",
           "Limit", "Lit", "LogicalJoin", "LogicalQuery", "PLAN_CACHE",
           "PlanCache", "Project", "QueryBuilder", "Scan", "Sort", "as_ir",
           "col", "execute", "lit", "lower"]
