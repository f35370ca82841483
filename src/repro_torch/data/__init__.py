"""Data substrate of the port: the synthetic oracle workload, the
token-level task of the model-backed arms, the prefetching pipeline and
the byte tokenizer."""
from .pipeline import DataPipeline, host_shard_fn
from .synth import OracleWorkload, make_token_task
from .tokenizer import VOCAB_SIZE, decode, encode, encode_batch

__all__ = [
    "OracleWorkload", "make_token_task",
    "DataPipeline", "host_shard_fn",
    "encode", "decode", "encode_batch", "VOCAB_SIZE",
]
