"""Share of the window's host time inside the arms' forwards, by the
program's own spans: the seconds of every ``arm.<name>.launch`` and
``arm.<name>.wait`` span, each clipped to the window, over the window (the
program's twin of ``engine.forward_share``)."""
from thriftbench.metrics._spans import arm_span, records, seconds, window


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    t0, t1 = window(ctx)
    launch, wait = arm_span("launch"), arm_span("wait")
    return seconds(recs, t0, t1, lambda n: launch(n) or wait(n)) / (t1 - t0)
