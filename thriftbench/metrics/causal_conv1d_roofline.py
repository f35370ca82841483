"""``causal_conv1d``'s share of its roofline over the traced slice, in %: the
sum of each launch's bound (its bytes at the HBM rate:
``thriftbench/rooflines/causal_conv1d.py``) over the sum of its device
time."""
from thriftbench.metrics._shared import roofline


def read(ctx):
    return roofline(ctx, "causal_conv1d")
