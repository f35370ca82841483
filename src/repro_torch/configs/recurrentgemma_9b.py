"""recurrentgemma-9b — hybrid RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427]
"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,                 # MQA
    d_ff=12288,
    vocab_size=256000,
    head_dim=256,
    rnn_width=4096,
    local_window=2048,
    block_pattern=("rec", "rec", "attn"),
    logits_softcap=30.0,
    tie_embeddings=True,
    dtype="bfloat16",
    num_microbatches=4,
    loss_chunk=1024,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke",
    family="hybrid",
    num_layers=5,
    d_model=64,
    num_heads=4,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    head_dim=16,
    rnn_width=64,
    local_window=16,
    block_pattern=("rec", "rec", "attn"),
    logits_softcap=30.0,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
