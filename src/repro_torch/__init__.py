"""ThriftLLM in PyTorch: the port of the JAX package ``repro`` to PyTorch and
CUDA on NVIDIA Hopper.

The package mirrors ``repro``'s layout and names. It imports ``torch``,
numpy and scipy, never ``jax`` and never ``repro``. Entry points run on
``device="cuda"`` unless the caller passes another device; the hand-written
kernels live in :mod:`repro_torch.kernels` with their CUDA sources in
``csrc/``.
"""
