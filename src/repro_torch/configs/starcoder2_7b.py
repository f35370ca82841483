"""starcoder2-7b — dense GQA + RoPE, non-gated GELU MLP. [arXiv:2402.19173]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    d_ff=18432,
    vocab_size=49152,
    mlp_variant="gelu",
    rope_theta=100000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    num_microbatches=4,
)

SMOKE = ModelConfig(
    name="starcoder2-smoke",
    family="dense",
    num_layers=2,
    d_model=72,                   # keeps 36-head-style non-pow2 ratio (9 heads)
    num_heads=9,
    num_kv_heads=3,
    d_ff=256,
    vocab_size=512,
    mlp_variant="gelu",
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
