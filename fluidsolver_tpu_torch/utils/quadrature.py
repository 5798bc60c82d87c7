"""Numerical quadrature (C19 parity: src/Quadrature.hpp:12-104): port of
``fluidsolver_tpu.utils.quadrature`` (numpy).

Gauss-Legendre points/weights come from numpy's generator instead of the
reference's 1,926-line constant table (src/QuadratureTables.hpp); the
composite midpoint/trapezoid/Simpson rules match the reference formulas.
"""

from __future__ import annotations

import numpy as np

MAX_QUAD_N = 64


def gauss_legendre(f, x_min: float, x_max: float, n: int = 16) -> float:
    """1D Gauss-Legendre integral of callable f over [x_min, x_max]."""
    if not 1 <= n <= MAX_QUAD_N:
        raise ValueError(f"n must be in [1, {MAX_QUAD_N}]")
    pts, wts = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (x_max - x_min) * pts + 0.5 * (x_max + x_min)
    return float(0.5 * (x_max - x_min) * np.sum(wts * f(x)))


def gauss_legendre_2d(f, x_min, x_max, y_min, y_max, n: int = 16) -> float:
    """Tensor-product 2D Gauss-Legendre (src/Quadrature.hpp:37-66)."""
    if not 1 <= n <= MAX_QUAD_N:
        raise ValueError(f"n must be in [1, {MAX_QUAD_N}]")
    pts, wts = np.polynomial.legendre.leggauss(n)
    x = 0.5 * (x_max - x_min) * pts + 0.5 * (x_max + x_min)
    y = 0.5 * (y_max - y_min) * pts + 0.5 * (y_max + y_min)
    W = wts[:, None] * wts[None, :]
    return float(0.25 * (x_max - x_min) * (y_max - y_min) * np.sum(W * f(x[:, None], y[None, :])))


def midpoint_rule(f_vals, dx: float) -> float:
    """(src/Quadrature.hpp:69-72)"""
    return float(np.sum(f_vals) * dx)


def trapezoidal_rule(f_vals, x) -> float:
    """(src/Quadrature.hpp:75-90)"""
    f_vals = np.asarray(f_vals)
    x = np.asarray(x)
    return float(np.sum((x[1:] - x[:-1]) * 0.5 * (f_vals[1:] + f_vals[:-1])))


def simpsons_rule(f_vals, x_min: float, x_max: float) -> float:
    """Composite Simpson; len(f_vals) must be odd (src/Quadrature.hpp:93-104)."""
    f_vals = np.asarray(f_vals)
    n = len(f_vals)
    if n <= 0 or n % 2 != 1:
        raise ValueError(f"need an odd number of samples, got {n}")
    res = np.sum(f_vals[0:-2:2] + 4.0 * f_vals[1:-1:2] + f_vals[2::2])
    dx = (x_max - x_min) / (n - 1)
    return float(res * dx / 3.0)
