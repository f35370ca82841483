"""smollm-135m — small llama-arch dense. [hf:HuggingFaceTB/SmolLM-135M; hf]"""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    rope_theta=10000.0,
    tie_embeddings=True,
    dtype="bfloat16",
    num_microbatches=1,
)

SMOKE = ModelConfig(
    name="smollm-smoke",
    family="dense",
    num_layers=3,
    d_model=48,
    num_heads=3,
    num_kv_heads=1,
    d_ff=128,
    vocab_size=512,
    tie_embeddings=True,
    dtype="float32",
    remat=False,
)
