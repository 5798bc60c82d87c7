"""Staggered-grid stencil operators: port of ``fluidsolver_tpu.ops.stencil``.

Shape legend (core/grid.py): center (nx+2, ny+2), U (nx+3, ny+2),
V (nx+2, ny+3); interior = [1:-1, 1:-1].
"""

from __future__ import annotations

import torch


def interp_u_center(U: torch.Tensor) -> torch.Tensor:
    """Ui(i,j) = (U(i,j) + U(i+1,j))/2 over all cells incl. ghosts."""
    return 0.5 * (U[:-1, :] + U[1:, :])


def interp_v_center(V: torch.Tensor) -> torch.Tensor:
    return 0.5 * (V[:, :-1] + V[:, 1:])


def interp_uv_center(u_stag: torch.Tensor, v_stag: torch.Tensor) -> torch.Tensor:
    """4-point average of a (u-stag, v-stag) pair onto cell centers."""
    return 0.25 * (u_stag[:-1, :] + u_stag[1:, :] + v_stag[:, :-1] + v_stag[:, 1:])


def divergence(U: torch.Tensor, V: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """div(i,j) = dU/dx + dV/dy over all cells incl. ghosts."""
    return (U[1:, :] - U[:-1, :]) / dx + (V[:, 1:] - V[:, :-1]) / dy


def mid_time(curr: torch.Tensor, old: torch.Tensor) -> torch.Tensor:
    """Crank-Nicolson midpoint."""
    return 0.5 * (curr + old)


def integrate(f: torch.Tensor, dx: float, dy: float, include_ghost: bool = False):
    s = torch.sum(f) if include_ghost else torch.sum(f[1:-1, 1:-1])
    return s * dx * dy


def shift_pressure_to_zero(dp: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Gauge fix. The reference subtracts the volume integral (sum times cell
    volume), not the mean; kept as the JAX package keeps it."""
    return dp - integrate(dp, dx, dy, include_ghost=True)
