"""Diffuse (volume-penalty) immersed boundary: port of
``fluidsolver_tpu.ib.diffuse``.

Solid fractions of the staggered control volumes by Gauss quadrature at
set-up, then direct forcing before the projection (reference:
examples/DiffuseIB.cpp:221-239, 296-315).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fluidsolver_tpu_torch.core import fields
from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.vof.init import gauss_cell_average_banded


@dataclasses.dataclass
class DiffuseIB:
    ib: torch.Tensor      # cell-centred solid fraction
    ib_u: torch.Tensor    # U-staggered control-volume solid fraction
    ib_v: torch.Tensor    # V-staggered control-volume solid fraction


def solid_fractions(indicator, grid: Grid, dtype: torch.dtype, device, n: int = 16) -> DiffuseIB:
    """Solid fractions over the staggered control volumes (the U volume is
    [x_i - dx/2, x_i + dx/2] x [y_j, y_j+1], DiffuseIB.cpp:222-238), by an
    n x n Gauss rule per volume on the host, in bands of rows; the fields
    go to ``device``."""
    def f(xs, ys):
        return np.asarray(indicator(xs, ys), dtype=np.float64)

    x, y, dx, dy = grid.x, grid.y, grid.dx, grid.dy
    Xf, Yl = np.meshgrid(x, y[:-1], indexing="ij")
    ib_u = gauss_cell_average_banded(f, Xf - dx / 2, Xf + dx / 2, Yl, Yl + dy, n)
    Xl, Yf = np.meshgrid(x[:-1], y, indexing="ij")
    ib_v = gauss_cell_average_banded(f, Xl, Xl + dx, Yf - dy / 2, Yf + dy / 2, n)
    X0, Y0 = np.meshgrid(x[:-1], y[:-1], indexing="ij")
    ib = gauss_cell_average_banded(f, X0, X0 + dx, Y0, Y0 + dy, n)

    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return DiffuseIB(ib=put(ib), ib_u=put(ib_u), ib_v=put(ib_v))


def apply_direct_forcing(U, V, ib: DiffuseIB, u_target: float = 0.0, v_target: float = 0.0):
    """U += ib (U_target - U) on the interior (DiffuseIB.cpp:296-312).
    Returns (U, V, fU dt, fV dt)."""
    dU = ib.ib_u[1:-1, 1:-1] * (u_target - U[1:-1, 1:-1])
    dV = ib.ib_v[1:-1, 1:-1] * (v_target - V[1:-1, 1:-1])
    return fields.add_interior(U, dU), fields.add_interior(V, dV), dU, dV
