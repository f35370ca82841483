"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref``) and the dispatching wrappers with launch counters (``ops``).
Each kernel builds from ``src/repro_torch/csrc/`` at its first CUDA launch."""
from . import ops, ref

__all__ = ["ops", "ref"]
