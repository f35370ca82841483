"""Share of the (query, wave) cells the router handed to the arms that lay
past each query's Prop. 4 stop, counted by the program: 1 - (sum of
``cells_used``) / (sum of ``cells_invoked``) over the ``router.finalize``
spans of the routes whose ``router.plan`` opened in the window (the routes
``router.wasted_invocations`` counts by its taps)."""
from thriftbench.metrics._spans import COUNTS, GROUP, NAME, opened, records, window


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    groups = {r[GROUP] for r in opened(recs, *window(ctx), "router.plan")}
    done = [r[COUNTS] for r in recs if r[NAME] == "router.finalize" and r[GROUP] in groups]
    invoked = sum(c["cells_invoked"] for c in done)
    return None if invoked == 0 else 1.0 - sum(c["cells_used"] for c in done) / invoked
