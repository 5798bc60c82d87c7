"""Device ms per step of the operations that start inside the program's
``twophase.vof`` range (reconstruction, advection, curvature), over the
profiled block; nothing where the range is absent."""

RANGE = "twophase.vof"


def read(run):
    if run.trace is None or not any(r.name == RANGE for r in run.trace.ranges):
        return None
    return run.trace.range_us(RANGE) / 1e3 / run.trace.steps
