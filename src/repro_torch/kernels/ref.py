"""Plain PyTorch versions of the port's kernels.

The CPU tests hold these to the JAX package, the kernel wrappers in
:mod:`repro_torch.kernels.ops` use them for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel to its plain version on the card.
"""
from __future__ import annotations

import torch

from repro_torch.core.belief import aggregate_log_beliefs_batch
from repro_torch.core.mc import _masked_xi_core


def belief_aggregate_ref(responses, log_weights, empty_belief, num_classes):
    """(log_beliefs (B, K) f32, predictions (B,) int32); votes summed in
    ascending arm order, first-max argmax."""
    beliefs = aggregate_log_beliefs_batch(responses, log_weights, num_classes, empty_belief)
    return beliefs, torch.argmax(beliefs, dim=-1).to(torch.int32)


def mc_correctness_grouped_ref(responses, masks, log_weights, empty_belief,
                               valid, theta, num_classes):
    """(G, C) f32 xi: the planner's exact grouped core, rounded to f32."""
    theta = torch.as_tensor(theta, device=responses.device).to(torch.float64)
    return _masked_xi_core(
        responses, masks, log_weights, empty_belief, valid, theta, num_classes,
    ).to(torch.float32)
