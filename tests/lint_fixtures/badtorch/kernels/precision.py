"""Seeded tf32-off violations (never imported; parsed only)."""
import torch


def fast_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = True  # FIRES: tf32-off
    torch.backends.cudnn.allow_tf32 = 1  # FIRES: tf32-off
    torch.set_float32_matmul_precision("high")  # FIRES: tf32-off


def exact_matmuls():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
