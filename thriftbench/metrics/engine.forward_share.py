"""Share of the window's host time spent inside ``LMArm.classify_batch``
(each call ends in copying its answers to the host)."""


def read(ctx):
    t0, t1 = ctx["window"]["t0"], ctx["window"]["t1"]
    inside = sum(max(0.0, min(e, t1) - max(s, t0)) for _, _, _, s, e in ctx["calls"])
    return inside / (t1 - t0)
