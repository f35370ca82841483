"""Per-layer metric readers, one file a metric (``<metric>.py`` with a
``read(ctx)`` that returns the value, or None where the run has nothing to
read), and the arithmetic they share (:mod:`thriftbench.metrics.arith`)."""
