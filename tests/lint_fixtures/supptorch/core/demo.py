"""Suppression-machinery fixture in torch (never imported; parsed only).

Three identical f64-reduction violations with different suppression
states: reasoned (silenced), reason-less (bad-suppression), and bare
(survives); ``Demo.forward`` makes them device-reachable.
"""
import torch


def suppressed_ok(w, x):
    return torch.sum(w * x)  # thriftlint: ignore[f64-reduction] fixture: pretend exactness is documented here


def reasonless(w, x):
    return torch.sum(w * x)  # thriftlint: ignore[f64-reduction]


def unsuppressed(w, x):
    return torch.sum(w * x)


class Demo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x):
        return suppressed_ok(w, x), reasonless(w, x), unsuppressed(w, x)
