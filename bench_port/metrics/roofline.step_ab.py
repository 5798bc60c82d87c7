"""``step_ab`` (``csrc/cg.cu``, the alpha half of a PCG iteration) against
its bound, in %: the bound over the mean device time of a launch.

At the finest level (the (nx + 2) x (ny + 2) box of the pressure unknowns)
the algorithm reads the five operator planes and x, r, p once and writes
x and r once: 10 planes. Its operations per point: A p (5 products, 4
sums), <p, Ap> (2), x + alpha p (2), r - alpha Ap (2), <r, r> (2), sum r
(1): 18. Every launch of the block is at the finest level."""

from bench_port.peaks import DTYPE_BYTES, bound_seconds

KERNEL = "step_ab_kernel"


def bytes_ops(nx: int, ny: int, dtype: str) -> tuple:
    points = (nx + 2) * (ny + 2)
    return 10 * points * DTYPE_BYTES[dtype], 18 * points


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernel(KERNEL)
    if not launches:
        return None
    mean_s = sum(op.us for op in launches) / len(launches) / 1e6
    b, f = bytes_ops(run.grid["nx"], run.grid["ny"], run.dtype)
    return 100.0 * bound_seconds(b, f, run.dtype) / mean_s
