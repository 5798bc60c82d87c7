"""Device ms per step of the operations that start inside the program's
``twophase.rhs`` range (each subiteration's divergence with the
pressure-jump increment, or the tangential and phase-change terms, and
the divergence source), over the profiled block; nothing where the range
is absent."""

from bench_port.metrics.momentum_ms_per_step import range_ms_per_step

RANGE = "twophase.rhs"


def read(run):
    return range_ms_per_step(run.trace, RANGE)
