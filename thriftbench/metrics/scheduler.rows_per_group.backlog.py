"""Rows a routed budget group carries: ``completed`` over ``batches`` of
``BatchScheduler.stats`` across the window."""
from thriftbench.metrics._shared import rows_per_group


def read(ctx):
    return rows_per_group(ctx)
