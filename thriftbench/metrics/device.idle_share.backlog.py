"""Share of the traced slice with no device operation running (profiler)."""
from thriftbench.metrics._shared import idle_share


def read(ctx):
    return idle_share(ctx)
