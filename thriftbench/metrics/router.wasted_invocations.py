"""Share of the rows handed to the arms in the window's routes that lay past
each query's Prop. 4 stop: 1 - (sum of stop waves) / (rows handed)."""
from thriftbench.metrics._shared import window_routes


def read(ctx):
    served = ctx["served"]
    handed = useful = 0
    for route in window_routes(ctx):
        handed += route["handed"]
        useful += int(served["stop"][route["qids"]].clip(min=0).sum())
    return None if handed == 0 else 1.0 - useful / handed
