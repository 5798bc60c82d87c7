"""VOF field initialization by per-cell Gauss-Legendre quadrature: a
torch-free copy of ``fluidsolver_tpu.vof.init`` (numpy, at set-up).

``liquid_fraction_from_indicator`` (and ``gauss_cell_average_banded``, which
``ib/diffuse.py`` uses) evaluates the rule in bands of grid rows so that a
1024^2 grid (16 x 16 points per cell) does not hold ~270M points at once;
each cell's arithmetic is that of the unbanded form.
"""

from __future__ import annotations

import numpy as np

from fluidsolver_tpu_torch.core.grid import Grid

ROWS_PER_BAND = 64


def gauss_cell_average(f, x_lo, x_hi, y_lo, y_hi, n: int = 16):
    """Average of f over each cell [x_lo,x_hi] x [y_lo,y_hi] by an n x n
    tensor-product Gauss rule. Inputs are broadcastable arrays of cell
    bounds; ``f(x, y)`` must be numpy-vectorized."""
    pts, wts = np.polynomial.legendre.leggauss(n)
    x_lo = np.asarray(x_lo)[..., None, None]
    x_hi = np.asarray(x_hi)[..., None, None]
    y_lo = np.asarray(y_lo)[..., None, None]
    y_hi = np.asarray(y_hi)[..., None, None]
    xs = 0.5 * (x_hi - x_lo) * pts[:, None] + 0.5 * (x_hi + x_lo)
    ys = 0.5 * (y_hi - y_lo) * pts[None, :] + 0.5 * (y_hi + y_lo)
    vals = f(xs, ys)
    w2 = wts[:, None] * wts[None, :]
    integral = np.sum(vals * w2, axis=(-2, -1)) * 0.25 * (x_hi - x_lo)[..., 0, 0] * (
        y_hi - y_lo
    )[..., 0, 0]
    return integral / ((x_hi - x_lo) * (y_hi - y_lo))[..., 0, 0]


def gauss_cell_average_banded(f, x_lo, x_hi, y_lo, y_hi, n: int = 16) -> np.ndarray:
    """``gauss_cell_average`` over 2D arrays of cell bounds of one shape,
    ``ROWS_PER_BAND`` rows at a time."""
    out = np.empty(np.shape(x_lo))
    for r in range(0, out.shape[0], ROWS_PER_BAND):
        band = slice(r, r + ROWS_PER_BAND)
        out[band] = gauss_cell_average(f, x_lo[band], x_hi[band], y_lo[band], y_hi[band], n)
    return out


def liquid_fraction_from_indicator(indicator, grid: Grid, n: int = 16) -> np.ndarray:
    """Cell-averaged volume fractions over the FULL ghost box (ghost cells
    are initialized too), f64 of shape (nx+2, ny+2)."""
    x = grid.x
    y = grid.y
    X_lo, Y_lo = np.meshgrid(x[:-1], y[:-1], indexing="ij")
    X_hi, Y_hi = np.meshgrid(x[1:], y[1:], indexing="ij")

    def f(xs, ys):
        return np.asarray(indicator(xs, ys), dtype=np.float64)

    return gauss_cell_average_banded(f, X_lo, X_hi, Y_lo, Y_hi, n)
