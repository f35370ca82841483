"""Serving runtime of the port: arm engine, plan service, ThriftLLM router."""
from .engine import OracleArm, PoolEngine
from .plans import GroupPlan, PlanService
from .router import PendingRoute, RouteResult, ThriftRouter

__all__ = [
    "OracleArm", "PoolEngine", "GroupPlan", "PlanService",
    "ThriftRouter", "RouteResult", "PendingRoute",
]
