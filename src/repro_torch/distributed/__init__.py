"""Distribution of the port: the serving fault-injection plane, straggler
tracking and the replica plane's device assignment (the sharding rules,
``replica_mesh`` and the training half of fault tolerance have no
counterpart yet)."""
from .fault import (
    FAULT_DEGRADE,
    FAULT_ERROR,
    FAULT_OK,
    FAULT_TIMEOUT,
    PROBE_WAVE,
    ArmFaultSpec,
    FaultPolicy,
    StragglerMitigator,
    attempted_failures,
    failover_gather,
    observed_faults,
)
from .sharding import replica_devices

__all__ = [
    "FAULT_OK", "FAULT_TIMEOUT", "FAULT_ERROR", "FAULT_DEGRADE", "PROBE_WAVE",
    "ArmFaultSpec", "FaultPolicy", "StragglerMitigator",
    "failover_gather", "attempted_failures", "observed_faults",
    "replica_devices",
]
