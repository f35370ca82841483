"""Model substrate of the port: configs, layers and the LM (forward only)."""
from .config import SHAPES, ModelConfig, ShapeConfig, shape_applicable
from .init import init_params, padded_vocab, unstack_params
from .model import LM, block_window

__all__ = [
    "ModelConfig", "ShapeConfig", "SHAPES", "shape_applicable",
    "init_params", "padded_vocab", "unstack_params", "LM", "block_window",
]
