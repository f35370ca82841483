"""musicgen-medium — decoder-only over EnCodec tokens. [arXiv:2306.05284]

The EnCodec/conditioning frontend is a stub per the assignment:
``input_specs`` provides precomputed conditioning frame embeddings.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    mlp_variant="gelu",
    frontend="audio",
    frontend_len=64,
    rope_theta=10000.0,
    tie_embeddings=False,
    dtype="bfloat16",
    num_microbatches=2,
)

SMOKE = ModelConfig(
    name="musicgen-smoke",
    family="audio",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=128,
    vocab_size=256,
    mlp_variant="gelu",
    frontend="audio",
    frontend_len=8,
    tie_embeddings=False,
    dtype="float32",
    remat=False,
)
