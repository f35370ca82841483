"""The port's benchmark: one run of one cell (``run.py``), found by name from ``BENCHMARK.json``."""
