"""Data substrate of the port: the synthetic oracle workload."""
from .synth import OracleWorkload

__all__ = ["OracleWorkload"]
