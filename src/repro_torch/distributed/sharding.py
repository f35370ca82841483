"""Replica-plane device placement.

The PyTorch port's counterpart of ``replica_devices`` in
``repro/distributed/sharding.py``. The rest of that module (the parameter
sharding rules and ``replica_mesh``, a ``jax.sharding.Mesh`` over the
replica axis) has no counterpart yet: it waits for the port's distribution
tools (ROADMAP Queue 1 item 8).
"""
from __future__ import annotations

import torch


def replica_devices(replicas: int, device="cuda") -> list:
    """Device assignment for an R-replica serving plane.

    With more than one CUDA device and a CUDA ``device``, replicas
    round-robin over the cards: under ``ReplicaSet(placement="overlapped")``
    each :class:`~repro_torch.serving.replica.ReplicaWorker`'s router runs
    its wave programs on its assigned card, so R wave programs from one
    drive cycle run concurrently. On one card, or on the CPU, the
    assignment is ``None`` everywhere: the workers keep the router's device
    (on one card each overlapped worker gets a CUDA stream of its own, and
    the default placement fuses same-budget replica waves along the batch
    axis instead).
    """
    device = torch.device(device)
    n = torch.cuda.device_count() if device.type == "cuda" else 0
    if n <= 1:
        return [None] * int(replicas)
    return [torch.device("cuda", i % n) for i in range(int(replicas))]
