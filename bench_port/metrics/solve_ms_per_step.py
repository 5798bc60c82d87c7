"""Device ms per step of the operations that start inside the program's
``pcg.solve`` range (each PCG solve from its first kernel to its return,
with its V-cycles and guards and without the hierarchy build), over the
profiled block; nothing where the range is absent."""

from bench_port.metrics.momentum_ms_per_step import range_ms_per_step

RANGE = "pcg.solve"


def read(run):
    return range_ms_per_step(run.trace, RANGE)
