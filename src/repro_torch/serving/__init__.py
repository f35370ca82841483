"""Serving runtime of the port: arm engine, ThriftLLM router, plan service,
continuous-batching scheduler with its cost ledger, the R-replica serving
plane, online estimation feedback, fault injection and degradation
tracking.

The reference's compile-cache functions have no counterpart: the port runs
eagerly, with no ``jit`` programs to cache.
"""
from repro_torch.distributed.fault import ArmFaultSpec, FaultPolicy

from .engine import LMArm, OracleArm, PoolEngine, USD_PER_FLOP
from .feedback import (
    DegradationTracker,
    FeedbackLog,
    FeedbackReport,
    FeedbackShard,
    merge_counts,
)
from .plans import GroupPlan, PlanService
from .replica import ReplicaSet, ReplicaWorker
from .router import PendingRoute, RouteResult, ThriftRouter
from .scheduler import (
    BatchScheduler,
    BlockFuture,
    CostLedger,
    Request,
    RequestFuture,
    RequestResult,
)

__all__ = [
    "LMArm", "OracleArm", "PoolEngine", "USD_PER_FLOP",
    "FeedbackLog", "FeedbackReport", "DegradationTracker",
    "FeedbackShard", "merge_counts",
    "GroupPlan", "PlanService",
    "ThriftRouter", "RouteResult", "PendingRoute",
    "BatchScheduler", "Request", "RequestFuture", "RequestResult",
    "BlockFuture", "CostLedger", "ReplicaSet", "ReplicaWorker",
    "ArmFaultSpec", "FaultPolicy",
]
