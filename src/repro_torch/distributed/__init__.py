"""Distribution of the port: fault tolerance (the training half —
heartbeats, elastic re-mesh planning, the checkpoint/restart driver — and
the serving fault-injection plane), straggler tracking, the logical-axis
sharding rules with their parameter, cache and batch specs, sharded
state over a ``DeviceMesh`` (``DTensor`` layout, gather at use, batch
blocks), and the replica plane's device assignment and mesh."""
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
from .sharding import (
    CACHE_LOGICAL,
    DEFAULT_RULES,
    PARAM_LOGICAL,
    ZERO3_LEAVES,
    AxisRules,
    Mesh,
    Sharding,
    active_rules,
    batch_block,
    batch_specs,
    cache_specs,
    constrain,
    constrain_params,
    distribute,
    distribute_parameters,
    gather,
    mesh_shape,
    param_specs,
    placements,
    replica_devices,
    replica_mesh,
    replicated,
    unshard,
    use_rules,
)

__all__ = [
    "FAULT_OK", "FAULT_TIMEOUT", "FAULT_ERROR", "FAULT_DEGRADE", "PROBE_WAVE",
    "ArmFaultSpec", "FaultPolicy", "StragglerMitigator",
    "failover_gather", "attempted_failures", "observed_faults",
    "HeartbeatMonitor", "plan_elastic_remesh", "rebatch_for_mesh", "FaultTolerantDriver",
    "replica_devices", "replica_mesh",
    "DEFAULT_RULES", "ZERO3_LEAVES", "PARAM_LOGICAL", "CACHE_LOGICAL", "Mesh", "Sharding",
    "AxisRules", "mesh_shape", "use_rules", "active_rules", "constrain", "constrain_params",
    "param_specs", "cache_specs", "batch_specs", "replicated",
    "placements", "distribute", "distribute_parameters", "gather", "unshard", "batch_block",
]
