"""Distribution of the port: fault tolerance (the training half —
heartbeats, elastic re-mesh planning, the checkpoint/restart driver — and
the serving fault-injection plane), straggler tracking and the replica
plane's device assignment (the sharding rules and ``replica_mesh`` have no
counterpart yet)."""
from .fault import (
    FAULT_DEGRADE,
    FAULT_ERROR,
    FAULT_OK,
    FAULT_TIMEOUT,
    PROBE_WAVE,
    ArmFaultSpec,
    FaultPolicy,
    FaultTolerantDriver,
    HeartbeatMonitor,
    StragglerMitigator,
    attempted_failures,
    failover_gather,
    observed_faults,
    plan_elastic_remesh,
    rebatch_for_mesh,
)
from .sharding import replica_devices

__all__ = [
    "FAULT_OK", "FAULT_TIMEOUT", "FAULT_ERROR", "FAULT_DEGRADE", "PROBE_WAVE",
    "ArmFaultSpec", "FaultPolicy", "StragglerMitigator",
    "failover_gather", "attempted_failures", "observed_faults",
    "HeartbeatMonitor", "plan_elastic_remesh", "rebatch_for_mesh", "FaultTolerantDriver",
    "replica_devices",
]
