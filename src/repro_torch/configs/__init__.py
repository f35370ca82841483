"""Architecture registry of the port: ``get_config(arch)`` resolves here.

The port's copy of ``repro/configs``. Each ported architecture has a module
exporting ``CONFIG`` (the exact published configuration) and ``SMOKE`` (a
reduced same-family config for CPU tests), copied verbatim. The port runs
the dense, hybrid and SSM families; the other architectures of the JAX
registry need blocks or frontends the port does not have yet (MoE, vision,
audio), and asking for one raises a ``KeyError`` that says so.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.models.config import ModelConfig

_MODULES: Dict[str, str] = {
    "falcon-mamba-7b": "falcon_mamba_7b",
    "smollm-135m": "smollm_135m",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

_NOT_PORTED = (
    "moonshot-v1-16b-a3b", "granite-moe-1b-a400m", "internvl2-2b",
    "h2o-danube-1.8b", "qwen1.5-110b", "starcoder2-7b", "musicgen-medium",
)


def list_archs() -> List[str]:
    return list(_MODULES)


def _module(arch: str):
    if arch in _NOT_PORTED:
        raise KeyError(
            f"arch {arch!r} is not ported yet; the port has: {list(_MODULES)}"
        )
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
