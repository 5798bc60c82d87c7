"""Moving-least-squares interpolation stencils: port of
``fluidsolver_tpu.ib.mls`` (the reference's examples/MovingLeastSquaresIB.cpp
:106-190, a cubic-spline weight and linear-basis MLS shape functions over a
small sample stencil, an interpolation experiment for IB targets)."""

from __future__ import annotations

import torch


def cubic_spline_weight(r, h):
    """The cardinal cubic-spline kernel with support 2h."""
    q = torch.abs(r) / h
    w1 = 2.0 / 3.0 - q * q + 0.5 * q * q * q
    w2 = (2.0 - q) ** 3 / 6.0
    return torch.where(q <= 1.0, w1, torch.where(q <= 2.0, w2, torch.zeros_like(q)))


def _shape_functions(sx, sy, w, ex, ey):
    """phi_i = p(e)^T (sum_j w_j p_j p_j^T)^{-1} w_i p_i for the linear
    basis p = [1, x, y], batched over the trailing sample axis."""
    P = torch.stack([torch.ones_like(sx), sx, sy], dim=-1)  # (..., n, 3)
    A = torch.einsum("...n,...ni,...nj->...ij", w, P, P)
    pe = torch.stack([torch.ones_like(ex), ex, ey], dim=-1)  # (..., 3)
    sol = torch.linalg.solve(A, pe[..., None])[..., 0]  # A^{-1} p(e)
    return w * torch.einsum("...ni,...i->...n", P, sol)


def mls_shape_functions(px, py, ex, ey, h):
    """MLS shape functions of the samples (px, py) at the points (ex, ey)."""
    r = torch.sqrt((px - ex[..., None]) ** 2 + (py - ey[..., None]) ** 2)
    return _shape_functions(px, py, cubic_spline_weight(r, h), ex, ey)


def mls_interpolate(px, py, values, ex, ey, h):
    return torch.sum(mls_shape_functions(px, py, ex, ey, h) * values, dim=-1)


# ---- the reference example's evaluators (MovingLeastSquaresIB.cpp:52-190):
# nearest-neighbour point sampling and the 5-point MLS stencil around it ----
def _nn_index(pos, g0: float, delta: float, n: int):
    """Nearest interior grid index, clamped to [0, n-1] (rounding half to
    even, as ``jnp.round``)."""
    return torch.clamp(torch.round((pos - g0) / delta).to(torch.int64), 0, n - 1)


def eval_field_at_nn(field, x0: float, dx: float, y0: float, dy: float, px, py):
    """Nearest-neighbour sample of a ghosted field at (px, py); ``x0``/``y0``
    are the first interior coordinates of the field's axes."""
    i = _nn_index(px, x0, dx, field.shape[0] - 2)
    j = _nn_index(py, y0, dy, field.shape[1] - 2)
    return field[i + 1, j + 1]


def eval_field_at_mls5(field, x0: float, dx: float, y0: float, dy: float, px, py,
                       box_scale: float = 1.2):
    """5-point MLS sample: the nearest node and its 4 axis neighbours,
    weighted by the reference's compact cubic kernel (the cardinal cubic
    spline with support 1, ``cubic_spline_weight(r, 0.5)``) over the
    box-scaled distance r = |p - e| / (box_scale d) per axis."""
    ni, nj = field.shape[0] - 2, field.shape[1] - 2
    inn = _nn_index(px, x0, dx, ni)
    jnn = _nn_index(py, y0, dy, nj)
    di = torch.tensor([0, -1, 1, 0, 0], device=px.device)
    dj = torch.tensor([0, 0, 0, -1, 1], device=px.device)
    ii = torch.clamp(inn[..., None] + di, 0, ni - 1)
    jj = torch.clamp(jnn[..., None] + dj, 0, nj - 1)
    sx = x0 + ii.to(px.dtype) * dx
    sy = y0 + jj.to(py.dtype) * dy
    r = torch.sqrt(((sx - px[..., None]) / (box_scale * dx)) ** 2
                   + ((sy - py[..., None]) / (box_scale * dy)) ** 2)
    phi = _shape_functions(sx, sy, cubic_spline_weight(r, 0.5), px, py)
    return torch.sum(phi * field[ii + 1, jj + 1], dim=-1)
