"""``mamba_scan``'s share of its roofline over the traced slice, in %: the
sum of each launch's bound (max of operations at the f32 peak outside the
tensor cores and bytes at the HBM rate) over the sum of its device time."""
from thriftbench.metrics._shared import mamba


def read(ctx):
    return mamba(ctx)
