"""Production mesh layouts and the card's constants (the port of
``repro/launch/mesh.py``).

The meshes are layouts: axis names and sizes, no devices (the counterpart
of ``jax.sharding.AbstractMesh``), so the sharding rules, the specs and
the dry run work out a 256- or 512-device layout on any machine. Defined
as functions, never module-level constants, as in the JAX package.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256-device single pod, or 2x16x16 = 512-device two-pod mesh."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 1, model: int = 1) -> Mesh:
    """A small ``("data", "model")`` layout for tests."""
    return Mesh(("data", "model"), (data, model))


# NVIDIA H100 SXM5 80GB at 700 W, datasheet values, per card, under the
# keys of the JAX package's TPU v5e table so that ``roofline_terms`` reads
# them unchanged.
HW = {
    "peak_flops": 989e12,      # dense bf16 tensor-core FLOP/s
    "hbm_bw": 3.35e12,         # HBM3 bytes/s
    # NVLink 4: 900 GB/s per GPU both ways, 450e9 bytes/s each way. Not a
    # TPU's ICI: a 16-wide model axis spans two 8-GPU NVLink nodes, whose
    # link between them one rate does not model.
    "ici_bw": 450e9,
    "hbm_bytes": 80e9,         # device memory
}
