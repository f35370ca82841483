"""falcon-mamba-7b — attention-free Mamba-1 SSM. [arXiv:2410.05355]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="falcon-mamba-7b",
    family="ssm",
    num_layers=64,
    d_model=4096,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=65024,
    ssm_state=16,
    ssm_conv=4,
    ssm_expand=2,
    ssm_chunk=256,
    block_pattern=("ssm",),
    tie_embeddings=False,
    dtype="bfloat16",
    num_microbatches=4,
)

SMOKE = ModelConfig(
    name="falcon-mamba-smoke",
    family="ssm",
    num_layers=2,
    d_model=64,
    num_heads=0,
    num_kv_heads=0,
    d_ff=0,
    vocab_size=512,
    ssm_state=8,
    ssm_chunk=8,
    block_pattern=("ssm",),
    tie_embeddings=False,
    dtype="float32",
    remat=False,
)
