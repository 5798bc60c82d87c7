"""``fused_momentum`` (``csrc/momentum.cu``, one subiteration's density
transport and momentum update) against its bound, in %: the bound over the
mean device time of a launch.

On the (nx + 2) x (ny + 2) centre box the algorithm reads twelve planes
once (U, V, U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v and the two
jump planes on faces, visc and p on centres) and writes four (rho_u,
rho_v, U, V on faces): 16 planes, counted at the centre box's size. Its
operations: the density fluxes and update (about 20 a face), the momentum
fluxes with upwinding, viscous and pressure terms and the update (about 60
a face), two faces a cell: 160 a point, far below the bytes' bound."""

from bench_port.peaks import DTYPE_BYTES, bound_seconds

KERNEL = "fused_momentum_kernel"


def bytes_ops(nx: int, ny: int, dtype: str) -> tuple:
    points = (nx + 2) * (ny + 2)
    return 16 * points * DTYPE_BYTES[dtype], 160 * points


def read(run):
    if run.trace is None:
        return None
    launches = run.trace.kernel(KERNEL)
    if not launches:
        return None
    mean_s = sum(op.us for op in launches) / len(launches) / 1e6
    b, f = bytes_ops(run.grid["nx"], run.grid["ny"], run.dtype)
    return 100.0 * bound_seconds(b, f, run.dtype) / mean_s
