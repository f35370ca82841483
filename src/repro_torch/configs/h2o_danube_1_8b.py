"""h2o-danube-1.8b — dense llama/mistral mix with sliding-window attention.
[arXiv:2401.16818; hf]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    num_layers=24,
    d_model=2560,
    num_heads=32,
    num_kv_heads=8,
    d_ff=6912,
    vocab_size=32000,
    window=4096,                  # sliding-window attention
    rope_theta=10000.0,
    tie_embeddings=False,
    dtype="bfloat16",
    num_microbatches=2,
)

SMOKE = ModelConfig(
    name="danube-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    window=16,
    tie_embeddings=False,
    dtype="float32",
    remat=False,
)
