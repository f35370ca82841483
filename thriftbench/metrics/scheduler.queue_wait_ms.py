"""Mean wait of an admitted query from its arrival to its admission, in ms:
the sums of ``wait_s`` over the sums of ``rows`` of the program's
``scheduler.dispatch`` spans opened in the window. By Little's law it is
the mean queue over the throughput. The backlog law fixes the queue (it
tops it up to ``ahead_groups`` x ``max_batch`` before every pump), so in
the backlog cells it reads 128 / ``queries_per_s`` to within 1%, and says
nothing of the scheduler's own there; it reads the scheduler where
arrivals do not wait on service."""
from thriftbench.metrics._spans import COUNTS, opened, records, window


def read(ctx):
    recs = records(ctx)
    if recs is None:
        return None
    spans = opened(recs, *window(ctx), "scheduler.dispatch")
    rows = sum(r[COUNTS]["rows"] for r in spans)
    return None if rows == 0 else 1000.0 * sum(r[COUNTS]["wait_s"] for r in spans) / rows
