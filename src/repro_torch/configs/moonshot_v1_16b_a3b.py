"""moonshot-v1-16b-a3b — MoE, 64 experts top-6 (Moonlight-16B-A3B family).
[hf:moonshotai/Moonlight-16B-A3B; hf]

The JAX package's guessed layout under this name (48 layers of GQA 16/16 at
head dim 128, a softmax top-6 router over experts of width 1408, a tied
head, no shared experts and no dense first layer), copied verbatim and kept
for parity with it. The published model, latent attention and all, is
``moonlight_16b_a3b.py`` (``moonlight-16b-a3b``).
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    num_layers=48,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    block_pattern=("moe",),
    rope_theta=50000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    num_microbatches=4,
    loss_chunk=1024,
)

SMOKE = ModelConfig(
    name="moonshot-smoke",
    family="moe",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=48,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    block_pattern=("moe",),
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
