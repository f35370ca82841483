"""Seeded kernel-contract violations in the wrappers (never imported;
parsed only)."""
import torch

from . import ref
from . import toy as _toy


def toy(x):
    # the contract: a CPU branch that calls the plain version, else launch
    if x.device.type == "cpu":
        return ref.toy_ref(x)
    return _toy.launch(x)


def _launch_pair(x, y):
    return _toy.launch_pair(x, y)


def pair(x, y):
    # reaches its launch through the function it hands on
    if x.device.type == "cpu":
        return ref.pair_ref(x)
    return torch.autograd.Function.apply(_launch_pair, x, y)


def unreferenced(x):  # FIRES: kernel-contract
    return _toy.launch(x)


def no_cpu_branch(x):  # FIRES: kernel-contract
    return _toy.launch(x)


def doubled(x):
    # calls a wrapper, not a launch: no wrapper itself
    return toy(toy(x))
