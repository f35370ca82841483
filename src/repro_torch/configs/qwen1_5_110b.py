"""qwen1.5-110b — dense GQA with QKV bias. [hf:Qwen/Qwen1.5-*; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-110b",
    family="dense",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=49152,
    vocab_size=152064,
    qkv_bias=True,
    rope_theta=1000000.0,
    tie_embeddings=False,
    dtype="bfloat16",
    num_microbatches=16,
    loss_chunk=1024,
)

SMOKE = ModelConfig(
    name="qwen-smoke",
    family="dense",
    num_layers=2,
    d_model=64,
    num_heads=4,
    num_kv_heads=2,
    d_ff=128,
    vocab_size=512,
    qkv_bias=True,
    tie_embeddings=False,
    dtype="float32",
    remat=False,
)
