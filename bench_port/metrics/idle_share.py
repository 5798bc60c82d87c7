"""The device's idle share over the profiled block, in %: 100 (1 - busy /
wall), busy being the union of the device operations' intervals."""


def read(run):
    if run.trace is None or not run.trace.ops:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.wall_s)
