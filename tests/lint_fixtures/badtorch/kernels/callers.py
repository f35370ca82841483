"""Seeded kernel-contract violations around the wrappers: fallbacks and
device choices (never imported; parsed only)."""
import torch

from . import ref
from . import toy as _toy
from .ops import toy


def silent_fallback(x):
    try:
        return _toy.launch(x)
    except RuntimeError:  # FIRES: kernel-contract
        return ref.toy_ref(x)


def swallowed(x):
    try:
        out = toy(x)
    except RuntimeError:  # FIRES: kernel-contract
        out = None
    return out


def _launch_toy(x):
    return _toy.launch(x)


def handed_fallback(x):
    # reaches the launch only through the function it hands on
    try:
        return torch.autograd.Function.apply(_launch_toy, x)
    except RuntimeError:  # FIRES: kernel-contract
        return ref.toy_ref(x)


def reraised(x):
    try:
        return toy(x)
    except RuntimeError as err:
        raise RuntimeError("the toy kernel failed") from err


def pick_device(x):
    dev = "cuda" if torch.cuda.is_available() else "cpu"  # FIRES: kernel-contract
    return toy(x.to(dev))


def needs_card(x):
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    return toy(x)
