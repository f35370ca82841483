"""moonlight-16b-a3b — Moonlight-16B-A3B as published (DeepSeek-V3 layout):
27 layers at width 2048; latent attention (kv_lora_rank 512, no q_lora_rank;
16 heads, q/k 128 + 64 RoPE, v 128); layer 0 a dense SwiGLU of width 11264,
layers 1-26 64 routed experts of width 1408, top 6, beside 2 shared; sigmoid
scores with a selection bias (``noaux_tc``, one group), the chosen scores
normalised and scaled by 2.446; an untied head over 163840 tokens.
[hf:moonshotai/Moonlight-16B-A3B/blob/main/config.json]

The port's own: the JAX package has no such layout (its
``moonshot_v1_16b_a3b`` is a guessed GQA one), so the registry's list of
architectures, which is the JAX package's, does not name it;
``get_config`` resolves it all the same. RoPE rotates halves, as every
block of the port does: the published checkpoint's interleaved q_pe/k_pe
layout is a fixed permutation of those weight columns.
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="moonlight-16b-a3b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=11264,
    vocab_size=163840,
    num_experts=64,
    experts_per_token=6,
    block_pattern=("mla_moe",),
    rope_theta=50000.0,
    tie_embeddings=False,
    norm_eps=1e-5,
    kv_lora_rank=512,
    qk_nope_head_dim=128,
    qk_rope_head_dim=64,
    v_head_dim=128,
    expert_d_ff=1408,
    num_shared_experts=2,
    router_scoring="sigmoid",
    routed_scaling=2.446,
    first_dense_layers=1,
    dtype="bfloat16",
)

SMOKE = ModelConfig(
    name="moonlight-smoke",
    family="moe",
    num_layers=3,
    d_model=64,
    num_heads=4,
    num_kv_heads=4,
    d_ff=96,
    vocab_size=512,
    num_experts=8,
    experts_per_token=2,
    block_pattern=("mla_moe",),
    rope_theta=50000.0,
    tie_embeddings=False,
    norm_eps=1e-5,
    kv_lora_rank=32,
    qk_nope_head_dim=16,
    qk_rope_head_dim=8,
    v_head_dim=16,
    expert_d_ff=24,
    num_shared_experts=2,
    router_scoring="sigmoid",
    routed_scaling=2.446,
    first_dense_layers=1,
    dtype="float32",
    remat=False,
)
