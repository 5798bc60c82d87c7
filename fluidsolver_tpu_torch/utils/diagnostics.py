"""Flow diagnostics: port of ``fluidsolver_tpu.utils.diagnostics``. VOF
stats, bubble metrics (on tensors, on their device) and dimensionless
numbers.

Mirrors the per-step observation quantities of the reference drivers
(examples/TwoPhaseSolver.cpp:87-100, examples/RisingBubble.cpp:140-183,
285-341)."""

from __future__ import annotations

import numpy as np
import torch

from fluidsolver_tpu_torch.core.grid import Grid


def vof_stats(vf, init_integral, dx: float, dy: float):
    """(min, max, integral, loss) incl. ghosts (TwoPhaseSolver.cpp:87-100)."""
    integral = torch.sum(vf) * dx * dy
    return torch.min(vf), torch.max(vf), integral, init_integral - integral


def center_of_mass(vf, grid: Grid):
    """Interior-only weighted centroid (RisingBubble.cpp:285-305)."""
    xm = torch.as_tensor(grid.xm[1:-1], dtype=vf.dtype, device=vf.device)
    ym = torch.as_tensor(grid.ym[1:-1], dtype=vf.dtype, device=vf.device)
    v = vf[1:-1, 1:-1]
    vol = torch.sum(v) * grid.dx * grid.dy
    wx = torch.sum(xm[:, None] * v) * grid.dx * grid.dy
    wy = torch.sum(ym[None, :] * v) * grid.dx * grid.dy
    return wx / vol, wy / vol


def avg_phase_velocity(vf, U, V):
    """vf-weighted mean velocity of a phase (RisingBubble.cpp:308-321);
    pass (1 - vf) to track a gas bubble."""
    u_c = 0.5 * (U[:-1, :] + U[1:, :])
    v_c = 0.5 * (V[:, :-1] + V[:, 1:])
    tot = torch.sum(vf)
    return torch.sum(vf * u_c) / tot, torch.sum(vf * v_c) / tot


# ---- dimensionless numbers (RisingBubble.cpp:44-124) ----------------------
def eotvos(rho_l, gravity, L, sigma):
    return np.inf if sigma == 0.0 else rho_l * abs(gravity) * L**2 / sigma


def galilei(gravity, L, rho_l, visc_l):
    return abs(gravity) * L**3 * rho_l**2 / visc_l**2


def weber(rho_l, U, L, sigma):
    return np.inf if sigma == 0.0 else rho_l * U**2 * L / sigma


def reynolds(rho_l, U, L, visc_l):
    return rho_l * U * L / visc_l


def morton(gravity, visc_g, rho_l, sigma):
    return np.inf if sigma == 0.0 else abs(gravity) * visc_g**4 / (rho_l * sigma**3)


def capillary(visc, U, sigma):
    return np.inf if sigma == 0.0 else visc * U / sigma


def ohnesorge(we, re):
    return np.sqrt(we) / re
