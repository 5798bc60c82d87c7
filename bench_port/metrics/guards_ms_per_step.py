"""Device ms per step of the operations that start inside the program's
``pcg.guards`` range (each PCG iteration's breakdown guard, best-iterate
selects and exit bookkeeping), over the profiled block; nothing where the
range is absent."""

from bench_port.metrics.momentum_ms_per_step import range_ms_per_step

RANGE = "pcg.guards"


def read(run):
    return range_ms_per_step(run.trace, RANGE)
