"""Device ms per step of the operations that start inside the program's
``twophase.pressure`` range (each pressure solve with its hierarchy
build), over the profiled block; nothing where the range is absent."""

RANGE = "twophase.pressure"


def read(run):
    if run.trace is None or not any(r.name == RANGE for r in run.trace.ranges):
        return None
    return run.trace.range_us(RANGE) / 1e3 / run.trace.steps
