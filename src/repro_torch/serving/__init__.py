"""Serving runtime of the port: arm engine, plan service, ThriftLLM router."""
from .engine import LMArm, OracleArm, PoolEngine
from .plans import GroupPlan, PlanService
from .router import PendingRoute, RouteResult, ThriftRouter

__all__ = [
    "LMArm", "OracleArm", "PoolEngine", "GroupPlan", "PlanService",
    "ThriftRouter", "RouteResult", "PendingRoute",
]
