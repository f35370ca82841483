"""internvl2-2b — VLM: InternViT frontend (stub) + InternLM2-1.8B backbone.
[arXiv:2404.16821; hf]

The vision frontend is a stub per the assignment: ``input_specs`` provides
precomputed patch embeddings (B, frontend_len, d_model).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b",
    family="vlm",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=8,
    d_ff=8192,
    vocab_size=92553,
    frontend="vision",
    frontend_len=256,
    rope_theta=1000000.0,
    tie_embeddings=False,
    dtype="bfloat16",
    num_microbatches=2,
)

SMOKE = ModelConfig(
    name="internvl2-smoke",
    family="vlm",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    frontend="vision",
    frontend_len=8,
    tie_embeddings=False,
    dtype="float32",
    remat=False,
)
