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


def l1_norm(f: torch.Tensor, dx: float, dy: float, include_ghost: bool = False):
    s = torch.sum(torch.abs(f)) if include_ghost else torch.sum(torch.abs(f[1:-1, 1:-1]))
    return s * dx * dy


def shift_pressure_to_zero(dp: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    """Gauge fix. The reference subtracts the volume integral (sum times cell
    volume), not the mean; kept as the JAX package keeps it."""
    return dp - integrate(dp, dx, dy, include_ghost=True)


# ---- centred gradients with one-sided edge closure ------------------------------
def grad_centered(f: torch.Tensor, dx: float, dy: float):
    """d/dx and d/dy of a cell-centred field over the full ghost box, with
    second-order one-sided stencils on the outermost rows and columns."""
    dfdx = torch.zeros_like(f)
    dfdy = torch.zeros_like(f)
    dfdx[1:-1, :] = (f[2:, :] - f[:-2, :]) / (2.0 * dx)
    dfdx[0, :] = (-3.0 * f[0, :] + 4.0 * f[1, :] - f[2, :]) / (2.0 * dx)
    dfdx[-1, :] = (3.0 * f[-1, :] - 4.0 * f[-2, :] + f[-3, :]) / (2.0 * dx)
    dfdy[:, 1:-1] = (f[:, 2:] - f[:, :-2]) / (2.0 * dy)
    dfdy[:, 0] = (-3.0 * f[:, 0] + 4.0 * f[:, 1] - f[:, 2]) / (2.0 * dy)
    dfdy[:, -1] = (3.0 * f[:, -1] - 4.0 * f[:, -2] + f[:, -3]) / (2.0 * dy)
    return dfdx, dfdy


# ---- point sampling ---------------------------------------------------------
def _bilinear_indices(pos, g0: float, delta: float, n: int, clamp=None):
    """Lower and upper interior cell indices of the bilinear stencil at
    ``pos``, clamped to [0, n) (constant extrapolation outside). The offset
    is divided by a 0-d tensor: CUDA divides by a Python scalar as a
    multiplication by its reciprocal, which can leave a point on a node
    half an ulp below the integer, and ``floor(q + 1)`` then skips a cell
    (the JAX package's expression, kept); a true division rounds alike on
    the CPU and the card.

    ``clamp``: (g0_dom, n_dom, i0), the global domain of a slab's samples
    (see :func:`sample_centered_stack`); the tests and the clamped indices
    are then the domain's, [i0, i0 + n_dom)."""
    q = (pos - g0) / torch.full((), delta, dtype=pos.dtype, device=pos.device)
    prev = torch.floor(q).to(torch.int64)
    nxt = torch.floor(q + 1.0).to(torch.int64)
    g0_dom, n_dom, i0 = (g0, n, 0) if clamp is None else clamp
    lo = (pos <= g0_dom) | (prev < i0)
    hi = (pos >= g0_dom + (n_dom - 1) * delta) | (nxt >= i0 + n_dom)
    lo_i, hi_i = i0, i0 + n_dom - 1
    prev = torch.where(lo, lo_i, torch.where(hi, hi_i, prev))
    nxt = torch.where(lo, lo_i, torch.where(hi, hi_i, nxt))
    return prev, nxt


def _cell_offset(g0: float, idx, delta: float, dtype):
    """g0 + idx * delta evaluated in f64 and rounded once to ``dtype`` (the
    JAX package's int-times-float promotion under x64)."""
    return (g0 + idx.to(torch.float64) * delta).to(dtype)


def sample_centered(field, x0: float, dx: float, y0: float, dy: float, px, py):
    """Bilinear sample of a cell-centered ghosted field at points (px, py),
    clamped to the interior. ``x0``/``y0`` are the first interior center
    coordinates; the interior has field.shape - 2 cells."""
    return sample_centered_stack(field[None], x0, dx, y0, dy, px, py)[0]


def sample_centered_stack(fields, x0: float, dx: float, y0: float, dy: float, px, py,
                          x_clamp=None):
    """``sample_centered`` for a stack (F, nx+2, ny+2) of fields at the same
    points; returns (F,) + px.shape.

    ``x_clamp``: a slab's view (``parallel/dist_vof.py``), the tuple
    (x0_dom, n_dom, i0_loc). ``fields`` is then an x-slab, extended with
    halo rows, of a global array whose interior spans ``n_dom`` cells from
    the first centre ``x0_dom``; global interior cell 0 sits at the slab's
    interior index ``i0_loc`` and ``x0`` is the slab's shifted origin. The
    clamp tests run against the global domain, so constant extrapolation at
    the physical boundaries is the single-device sampler's, while the
    indices stay local. None: clamp to this array's own extent."""
    ip, inx = _bilinear_indices(px, x0, dx, fields.shape[1] - 2, x_clamp)
    jp, jnx = _bilinear_indices(py, y0, dy, fields.shape[2] - 2)
    f00 = fields[:, ip + 1, jp + 1]
    f10 = fields[:, inx + 1, jp + 1]
    f01 = fields[:, ip + 1, jnx + 1]
    f11 = fields[:, inx + 1, jnx + 1]
    xi = px - _cell_offset(x0, ip, dx, px.dtype)
    eta = py - _cell_offset(y0, jp, dy, py.dtype)
    a = (f10 - f00) / dx * xi + f00
    b = (f11 - f01) / dx * xi + f01
    return (b - a) / dy * eta + a
