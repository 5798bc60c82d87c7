"""Device ms per step of the operations that start inside the program's
``pcg.hierarchy`` range (each preconditioner hierarchy build: ``fused_rap``
at each level, the tail's setup, the dense coarsest inverse), over the
profiled block; nothing where the range is absent (a cell whose hierarchy
is built once, at set-up)."""

from bench_port.metrics.momentum_ms_per_step import range_ms_per_step

RANGE = "pcg.hierarchy"


def read(run):
    return range_ms_per_step(run.trace, RANGE)
