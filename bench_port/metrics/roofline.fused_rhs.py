"""``fused_rhs`` (``csrc/rhs.cu``, one two-phase subiteration's pressure
right-hand side: divergence, capillary jump and its increment) against its
bound, in %: the bound over the mean device time of a launch; nothing
where no launch was traced (the single-phase step has none).

On the (nx + 2) x (ny + 2) centre box the algorithm reads nine planes once
(U, V, the two face densities and the two old jumps on faces; vf,
curvature and interface length on centres) and writes three (div on
centres, the two jumps on faces): 12 planes, counted at the centre box's
size, which counts a face plane's extra row or column low. Its
operations: four face jumps (about 10 each), the increment (about 10) and
the divergence (5), about 60 a point, far below the bytes' bound."""

from bench_port.peaks import DTYPE_BYTES, bound_seconds

KERNEL = "fused_rhs_kernel"


def bytes_ops(nx: int, ny: int, dtype: str) -> tuple:
    points = (nx + 2) * (ny + 2)
    return 12 * points * DTYPE_BYTES[dtype], 60 * points


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernel(KERNEL)
    if not launches:
        return None
    mean_s = sum(op.us for op in launches) / len(launches) / 1e6
    b, f = bytes_ops(run.grid["nx"], run.grid["ny"], run.dtype)
    return 100.0 * bound_seconds(b, f, run.dtype) / mean_s
