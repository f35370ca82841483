"""Data substrate of the port: the synthetic oracle workload and the
token-level task of the model-backed arms."""
from .synth import OracleWorkload, make_token_task

__all__ = ["OracleWorkload", "make_token_task"]
