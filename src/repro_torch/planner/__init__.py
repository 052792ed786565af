"""Planner and cost model (mirrors ``src/repro/planner/__init__.py``; the
Database Designer is not ported yet)."""
from .cost import CostEstimate, join_distribution, scan_cost, selectivity
from .planner import PhysicalPlan, candidate_projections, plan_query

__all__ = ["CostEstimate", "PhysicalPlan", "candidate_projections",
           "join_distribution", "plan_query", "scan_cost", "selectivity"]
