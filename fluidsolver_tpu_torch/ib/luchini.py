"""Luchini second-order immersed boundary: port of
``fluidsolver_tpu.ib.luchini``.

Reference: src/IB.hpp:13-186, after Luchini et al. 2025 (JCP 114245). A
per-node correction lambda = (h - dist) / (dist h^2) accumulates over the
wall-adjacent directions (infinite inside the solid); the velocity update
is either an implicit-Euler division or the exact exponential-integrator
form. The lambda fields are made on the host at set-up (the native sweep
of ``csrc/ib_kernels.cpp`` for a circle, the Python loop for any other
shape); the updates are branch-free tensor code.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from fluidsolver_tpu_torch.core.fields import set_interior
from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.ib import _native
from fluidsolver_tpu_torch.ib.geometry import Circle


@dataclasses.dataclass
class LuchiniIB:
    corr_u: torch.Tensor  # U-staggered lambda field (inf inside the solid)
    corr_v: torch.Tensor  # V-staggered lambda field


def _correction_field(shape, xs, ys, dx: float, dy: float) -> np.ndarray:
    """calc_ib_correction_shape (src/IB.hpp:45-108) on one staggered mesh."""
    nx, ny = len(xs), len(ys)
    corr = np.zeros((nx, ny))
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    solid = np.asarray(shape.contains(X, Y), bool)
    for i in range(1, nx - 1):
        for j in range(1, ny - 1):
            if solid[i, j]:
                corr[i, j] = np.inf
                continue
            p = (xs[i], ys[j])
            if solid[i + 1, j]:
                ix, _ = shape.intersect_line(p, (xs[i + 1], ys[j]))
                dist = ix - p[0]
                corr[i, j] += (dx - dist) / (dist * dx * dx)
            if solid[i - 1, j]:
                ix, _ = shape.intersect_line(p, (xs[i - 1], ys[j]))
                dist = p[0] - ix
                corr[i, j] += (dx - dist) / (dist * dx * dx)
            if solid[i, j + 1]:
                _, iy = shape.intersect_line(p, (xs[i], ys[j + 1]))
                dist = iy - p[1]
                corr[i, j] += (dy - dist) / (dist * dy * dy)
            if solid[i, j - 1]:
                _, iy = shape.intersect_line(p, (xs[i], ys[j - 1]))
                dist = p[1] - iy
                corr[i, j] += (dy - dist) / (dist * dy * dy)
    return corr


def _correction(shape, xs, ys, dx: float, dy: float) -> np.ndarray:
    if isinstance(shape, Circle):
        return _native.luchini_correction_circle(xs, ys, dx, dy, shape.x, shape.y, shape.r)
    return _correction_field(shape, xs, ys, dx, dy)


def correction_fields(shape, grid: Grid, dtype: torch.dtype, device) -> LuchiniIB:
    """The U and V lambda fields of ``shape`` on ``grid``, on ``device``."""
    def put(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return LuchiniIB(corr_u=put(_correction(shape, grid.x, grid.ym, grid.dx, grid.dy)),
                     corr_v=put(_correction(shape, grid.xm, grid.y, grid.dx, grid.dy)))


def _face_visc_u(visc):
    return 0.5 * (visc[1:, 1:-1] + visc[:-1, 1:-1])


def _face_visc_v(visc):
    return 0.5 * (visc[1:-1, 1:] + visc[1:-1, :-1])


def _semi_analytical_coeffs(lam, dt):
    """B = lam dt / (exp(lam dt) - 1) (-> 1 as lam -> 0), A = lam dt + B
    (src/IB.hpp:145-151); the caller handles an infinite lambda."""
    x = lam * dt
    small = torch.abs(lam) < 1e-6
    one = torch.ones_like(x)
    safe = torch.where(small, one, x)
    B = torch.where(small, one, safe / torch.expm1(safe))
    return x + B, B


def _semi_analytical(corr, face_visc, dmom, dt, vel_old, rho_old, rho, vel):
    lam = face_visc / rho[1:-1, 1:-1] * corr[1:-1, 1:-1]
    inside = torch.isinf(lam)
    A, B = _semi_analytical_coeffs(torch.where(inside, torch.zeros_like(lam), lam), dt)
    new = (B * rho_old[1:-1, 1:-1] * vel_old[1:-1, 1:-1] + dt * dmom[1:-1, 1:-1]) / (A * rho[1:-1, 1:-1])
    return set_interior(vel, torch.where(inside, torch.zeros_like(new), new))


def update_velocity_semi_analytical(dmomU, dmomV, dt, ib: LuchiniIB, U_old, V_old, rho_u_old,
                                    rho_v_old, rho_u, rho_v, visc, U, V):
    """The exact exponential-integrator update (src/IB.hpp:129-186):
    U^{n+1} = (B rho_old U_old + dt dmom) / (A rho); U = 0 inside the solid."""
    return (_semi_analytical(ib.corr_u, _face_visc_u(visc), dmomU, dt, U_old, rho_u_old, rho_u, U),
            _semi_analytical(ib.corr_v, _face_visc_v(visc), dmomV, dt, V_old, rho_v_old, rho_v, V))


def correct_velocity_implicit_euler(U, V, ib: LuchiniIB, dt, visc, rho_u, rho_v):
    """U /= 1 + dt nu lambda (src/IB.hpp:110-127); an infinite lambda gives 0."""
    def one(vel, corr, face_visc, rho):
        fac = 1.0 + dt * (face_visc / rho[1:-1, 1:-1]) * corr[1:-1, 1:-1]
        inner = vel[1:-1, 1:-1]
        return set_interior(vel, torch.where(torch.isinf(fac), torch.zeros_like(inner), inner / fac))

    return (one(U, ib.corr_u, _face_visc_u(visc), rho_u),
            one(V, ib.corr_v, _face_visc_v(visc), rho_v))
