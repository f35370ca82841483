"""Production mesh layouts and the card's constants (the port of
``repro/launch/mesh.py``).

The production meshes are layouts: axis names and sizes, no devices (the
counterpart of ``jax.sharding.AbstractMesh``), so the sharding rules, the
specs and the dry run work out a 256- or 512-device layout on any machine.
:func:`make_mesh` (and :func:`make_debug_mesh` given a device type) builds
a real ``DeviceMesh`` over the ranks of a ``torch.distributed`` world, on
which the sharded train step runs. Defined as functions, never
module-level constants, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256-device single pod, or 2x16x16 = 512-device two-pod mesh."""
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_mesh(shape, axes, device_type: str):
    """``jax.make_mesh``: a named ``torch.distributed`` ``DeviceMesh`` of
    ``shape`` over the world's ranks, row-major (``"cuda"``: a rank per
    card, under NCCL; ``"cpu"``: gloo ranks). The process group must be
    initialised, its world size ``prod(shape)``."""
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, tuple(shape), mesh_dim_names=tuple(axes))


def make_debug_mesh(data: int = 1, model: int = 1, device_type: Optional[str] = None):
    """A small ``("data", "model")`` mesh: a :func:`make_mesh` device mesh
    with a ``device_type``, else a layout with no devices."""
    if device_type is not None:
        return make_mesh((data, model), ("data", "model"), device_type)
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
