"""Execution engine on torch: the fluent builder, logical IR, operators,
the cached fused executor, the single-node pipeline, the segmented
executor and the serving layer.  Mirrors ``src/repro/engine/__init__.py``."""
from .builder import QueryBuilder
from .executor import PLAN_CACHE, PlanCache
from .expr import Col, Expr, Lit, col, lit
from .logical import (Aggregate, Filter, Join, Limit, LogicalJoin,
                      LogicalQuery, Project, Scan, Sort, as_ir, lower)
from .pipeline import ExecStats, JoinSpec, Query, execute
from .segmented import execute_segmented
from .serving import (QueryService, ServiceStats, ServingStats, Session,
                      Ticket)

__all__ = ["Aggregate", "Col", "ExecStats", "Expr", "Filter", "Join",
           "JoinSpec", "Limit", "Lit", "LogicalJoin", "LogicalQuery",
           "PLAN_CACHE", "PlanCache", "Project", "Query", "QueryBuilder",
           "QueryService", "Scan", "ServiceStats", "ServingStats",
           "Session", "Sort", "Ticket", "as_ir", "col", "execute",
           "execute_segmented", "lit", "lower"]
