"""Host ms the router spends a budget group outside the arms: the seconds of
the program's ``router.plan``, ``router.wave`` and ``router.finalize`` spans
inside the window (each clipped to it) over the ``router.finalize`` spans
that closed in it."""
from thriftbench.metrics._spans import NAME, T1, records, seconds, window

OWN = ("router.plan", "router.wave", "router.finalize")


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    t0, t1 = window(ctx)
    groups = sum(1 for r in recs if r[NAME] == "router.finalize" and t0 <= r[T1] <= t1)
    return None if groups == 0 else 1000.0 * seconds(recs, t0, t1, OWN.__contains__) / groups
