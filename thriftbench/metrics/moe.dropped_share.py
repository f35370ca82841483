"""Share of the routed (token, slot) pairs that the MoE layers dropped past
their expert capacity over the traced slice, in every MoE layer of the
pool: the program's counter (``repro_torch.models.moe.PAIRS``, counted only
while the profiler records, from zero at each recording's start), dropped
over routed. None where the program keeps no such counter or routed
nothing."""


def read(ctx):
    if ctx["slice"] is None:
        return None
    try:
        from repro_torch.models import moe
    except ImportError:
        return None
    pairs = getattr(moe, "PAIRS", None)
    if pairs is None or pairs.routed() == 0:
        return None
    return pairs.dropped() / pairs.routed()
