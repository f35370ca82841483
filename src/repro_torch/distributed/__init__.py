"""Distribution of the port: the serving fault-injection plane and straggler
tracking (the sharding rules and the training half of fault tolerance have
no counterpart yet)."""
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

__all__ = [
    "FAULT_OK", "FAULT_TIMEOUT", "FAULT_ERROR", "FAULT_DEGRADE", "PROBE_WAVE",
    "ArmFaultSpec", "FaultPolicy", "StragglerMitigator",
    "failover_gather", "attempted_failures", "observed_faults",
]
