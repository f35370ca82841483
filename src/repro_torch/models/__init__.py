"""Model substrate of the port: configs, layers (the MoE FFN among them),
the LM and its loss."""
from .config import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .init import init_params, padded_vocab, unstack_params
from .model import IGNORE, LM, block_window, named_params
from .moe import capacity_for, moe_mlp, router_topk

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "init_params", "padded_vocab", "unstack_params", "LM", "block_window", "IGNORE",
    "named_params", "moe_mlp", "router_topk", "capacity_for",
]
