"""A kernel module of the fixture (never imported; parsed only)."""
from . import _build


def launch(x):
    return _build.entry("toy")(x)


def launch_pair(x, y):
    return _build.entry("toy")(x, y)
