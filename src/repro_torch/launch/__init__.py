"""Launchers and launch tools of the port: the serving CLI (``python -m
repro_torch.launch.serve``), the training CLI (``python -m
repro_torch.launch.train``), the dry run (``python -m
repro_torch.launch.dryrun``; not imported here, so that ``-m`` runs it
fresh), the production mesh layouts with the card's constants, the meta
input specs and the roofline accounting."""
from .mesh import HW, make_debug_mesh, make_production_mesh
from .roofline import (
    WIRE_FACTOR,
    analytic_bytes,
    analytic_flops,
    analytic_memory,
    flop_count,
    model_flops,
    roofline_terms,
    wire_bytes_per_chip,
)
from .specs import (
    batch_specs_for,
    decode_specs_for,
    input_specs,
    model_layout,
    opt_specs_for,
    param_specs_for,
)

__all__ = [
    "HW", "make_production_mesh", "make_debug_mesh",
    "WIRE_FACTOR", "analytic_flops", "analytic_bytes", "analytic_memory", "model_flops",
    "flop_count", "roofline_terms", "wire_bytes_per_chip",
    "batch_specs_for", "decode_specs_for", "param_specs_for", "opt_specs_for", "input_specs",
    "model_layout",
]
