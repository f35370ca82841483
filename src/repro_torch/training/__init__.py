"""Training substrate of the port: optimizer, train step, gradient compression."""
from .compression import CompressionConfig, compress_grads, init_residuals
from .optimizer import OptimizerConfig, adamw_init, adamw_update, global_norm, lr_at
from .train_loop import init_train_state, make_train_step

__all__ = [
    "OptimizerConfig", "adamw_init", "adamw_update", "global_norm", "lr_at",
    "CompressionConfig", "compress_grads", "init_residuals",
    "init_train_state", "make_train_step",
]
