"""Seeded f64-reduction violations, badrepro's ``core/reductions.py`` in
torch (never imported; parsed only). The functions are device-reachable
from ``Plan.forward``, a ``torch.autograd.Function`` method."""
import torch


def marginal_gain(w, x):
    g = torch.einsum("ij,j->i", w, x)  # FIRES: f64-reduction
    return torch.sum(g)  # FIRES: f64-reduction


def hashed_accumulate(x):
    total = 0.0
    for arm in {3, 1, 2}:  # FIRES: f64-reduction
        total += x[arm]
    return total


def explicit_ok(w, x):
    # explicit accumulator dtype: the contract-compliant spelling
    return torch.sum(w * x, dtype=torch.float64)


def exact_ok(a, b):
    # integer-exact indicator count: the other compliant spelling
    return (a == b).to(torch.int32).sum()


def cast_ok(w, x):
    # float64 operands: the cast spelling
    return (w.to(torch.float64) * x.double()).sum(-1)


def host_only(w, x):
    # reached from no device-plane root: not on the contract's plane
    return torch.sum(w * x)


class Plan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, w, x, a, b):
        return (marginal_gain(w, x), hashed_accumulate(x), explicit_ok(w, x),
                exact_ok(a, b), cast_ok(w, x))

    @staticmethod
    def backward(ctx, *grads):
        return None, None, None, None
