"""Planner, cost model and Database Designer (mirrors
``src/repro/planner/__init__.py``)."""
from .cost import CostEstimate, join_distribution, scan_cost, selectivity
from .designer import DesignReport, design
from .planner import PhysicalPlan, candidate_projections, plan_query

__all__ = ["CostEstimate", "DesignReport", "PhysicalPlan",
           "candidate_projections", "design", "join_distribution",
           "plan_query", "scan_cost", "selectivity"]
