"""Architecture registry of the port: ``get_config(arch)`` resolves here.

The port's copy of ``repro/configs``. Each ported architecture has a module
exporting ``CONFIG`` (the exact published configuration) and ``SMOKE`` (a
reduced same-family config for CPU tests), copied verbatim. The registry
lists the JAX package's ten architectures in its order: the dense, MoE,
SSM, hybrid, vision-language and audio families. ``get_config`` and
``get_smoke_config`` also resolve the port's own architectures
(:data:`PORT_ONLY`), which :func:`list_archs` leaves out: the JAX package
has no layout of theirs to hold them to.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "moonshot-v1-16b-a3b": "moonshot_v1_16b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "internvl2-2b": "internvl2_2b",
    "h2o-danube-1.8b": "h2o_danube_1_8b",
    "qwen1.5-110b": "qwen1_5_110b",
    "starcoder2-7b": "starcoder2_7b",
    "smollm-135m": "smollm_135m",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "musicgen-medium": "musicgen_medium",
}

# architectures of the port alone, as published
PORT_ONLY: Dict[str, str] = {
    "moonlight-16b-a3b": "moonlight_16b_a3b",
}


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch: str):
    known = {**_MODULES, **PORT_ONLY}
    if arch not in known:
        raise KeyError(f"unknown arch {arch!r}; known: {list(known)}")
    return importlib.import_module(f"repro_torch.configs.{known[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
