"""``flash_attention``'s share of its roofline over the traced slice, in %:
the sum of each launch's bound (max of operations at the bf16 peak and bytes
at the HBM rate, visible pairs only) over the sum of its device time."""
from thriftbench.metrics._shared import flash


def read(ctx):
    return flash(ctx)
