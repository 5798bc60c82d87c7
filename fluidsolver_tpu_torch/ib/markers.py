"""Lagrangian-marker immersed interface: port of ``fluidsolver_tpu.ib.markers``
(the reference's examples/II.cpp:77-159).

A closed ring of markers carries an elastic response force
F = K (X0 - X) - eta U and the pressure and viscous-stress jump conditions
computed from the marker normals. Marker velocities come from clamped
bilinear sampling; markers advect with the flow; ``spread_force`` puts the
force on the staggered grid with the 4-point Peskin cosine delta.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from fluidsolver_tpu_torch.core import bc
from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.ops.stencil import sample_centered


@dataclasses.dataclass
class Markers:
    x0: torch.Tensor
    y0: torch.Tensor
    x: torch.Tensor
    y: torch.Tensor
    u: torch.Tensor
    v: torch.Tensor


def init_circle(n: int, cx: float, cy: float, r: float, dtype: torch.dtype, device) -> Markers:
    theta = torch.as_tensor(np.linspace(0.0, 2.0 * np.pi, n, endpoint=False), dtype=dtype,
                            device=device)
    x = cx + r * torch.cos(theta)
    y = cy + r * torch.sin(theta)
    z = torch.zeros_like(x)
    return Markers(x0=x, y0=y, x=x, y=y, u=z, v=z)


def sample_velocity(m: Markers, Ui, Vi, grid: Grid) -> Markers:
    u = sample_centered(Ui, grid.xm[1], grid.dx, grid.ym[1], grid.dy, m.x, m.y)
    v = sample_centered(Vi, grid.xm[1], grid.dx, grid.ym[1], grid.dy, m.x, m.y)
    return dataclasses.replace(m, u=u, v=v)


def advect(m: Markers, dt) -> Markers:
    return dataclasses.replace(m, x=m.x + dt * m.u, y=m.y + dt * m.v)


def response_force(m: Markers, kappa: float, eta: float):
    """F = K (X0 - X) - eta U (II.cpp:110-116)."""
    return kappa * (m.x0 - m.x) - eta * m.u, kappa * (m.y0 - m.y) - eta * m.v


def marker_normals(m: Markers):
    """Averaged edge normals of the closed marker ring (II.cpp:118-144)."""
    def seg_normal(dx, dy):
        n = torch.sqrt(dx * dx + dy * dy)
        return -dy / n, dx / n

    t1x = m.x - torch.roll(m.x, 1)
    t1y = m.y - torch.roll(m.y, 1)
    t2x = torch.roll(m.x, -1) - m.x
    t2y = torch.roll(m.y, -1) - m.y
    n1x, n1y = seg_normal(t1x, t1y)
    n2x, n2y = seg_normal(t2x, t2y)
    return 0.5 * (n1x + n2x), 0.5 * (n1y + n2y)


def jump_conditions(m: Markers, kappa: float, eta: float):
    """Pressure and viscous-stress jumps from the response force
    (II.cpp:118-159, J^{-1} = 1)."""
    fu, fv = response_force(m, kappa, eta)
    nx, ny = marker_normals(m)
    return dict(
        p_jump=fu * nx + fv * ny,
        mu_dudx_jump=((1.0 - nx * nx) * fu + (1.0 - nx * ny) * fv) * nx,
        mu_dvdx_jump=((1.0 - nx * ny) * fu + (1.0 - ny * ny) * fv) * nx,
        mu_dudy_jump=((1.0 - nx * nx) * fu + (1.0 - nx * ny) * fv) * ny,
        mu_dvdy_jump=((1.0 - nx * ny) * fu + (1.0 - ny * ny) * fv) * ny,
    )


def _delta(r, h: float):
    """The 4-point Peskin cosine delta."""
    q = torch.abs(r) / h
    return torch.where(q < 2.0, 0.25 / h * (1.0 + torch.cos(math.pi * q / 2.0)), torch.zeros_like(q))


def spread_force(m: Markers, fu, fv, grid: Grid, u_shape, v_shape):
    """Spread the marker forces to the staggered grid with the 4-point
    Peskin cosine delta, as two separable products over the markers; the
    products have the shapes ``u_shape`` and ``v_shape`` (the staggered
    grids', kept as the JAX package's signature has them)."""
    ds = 2.0 * math.pi * torch.sqrt((m.x0[0] - m.x0.mean()) ** 2
                                    + (m.y0[0] - m.y0.mean()) ** 2) / m.x.shape[0]
    def coords(name):
        # the boundary conditions' cache on the device: a step copies
        # nothing from the host
        return bc._coords(grid, name, m.x.dtype, m.x.device)

    wx = _delta(coords("x")[:, None] - m.x[None, :], grid.dx)    # (nx+3, n)
    wy = _delta(coords("ym")[:, None] - m.y[None, :], grid.dy)   # (ny+2, n)
    fU = torch.einsum("in,jn,n->ij", wx, wy, fu * ds)
    wx = _delta(coords("xm")[:, None] - m.x[None, :], grid.dx)
    wy = _delta(coords("y")[:, None] - m.y[None, :], grid.dy)
    fV = torch.einsum("in,jn,n->ij", wx, wy, fv * ds)
    return fU, fV
