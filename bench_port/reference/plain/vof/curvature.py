"""Interface curvature from PLIC segments: port of
``fluidsolver_tpu.vof.curvature``.

For each interior mixed cell the 3x3 neighbourhood's PLIC segments are
rotated so that the cell's normal points to (0, -1) about its segment
midpoint, y = c0 + c1 x + c2 x^2 is fitted by matching the segments'
integrals in the least-squares sense (a symmetric 3x3 system solved by
Cramer's rule), and kappa = 2 c2 / (1 + c1^2)^(3/2); non-finite values and
cells with fewer than two segments give 0 (``curvature_quad_volume_matching``,
the port's kernel #11).

The two other estimators are plain PyTorch on either device (the JAX
package's reach no TPU kernel): ``curvature_quad_regression``, a
least-squares quadratic through the rotated segment midpoints, and
``curvature_convolved_vf``, -div(grad/|grad|) of vf smoothed by a compact
polynomial kernel, sampled at the segment midpoint or taken at the cell
centre. Both keep the JAX package's operand order; the 9 x 9 smoothing is
a fixed sequence of shifted adds, so it rounds alike on the CPU and the
card (no TF32 convolution).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from bench_port.reference.plain.core.grid import Grid
from bench_port.reference.plain.ops.stencil import grad_centered, sample_centered
from bench_port.reference.plain.core.fields import pad_interior
from bench_port.reference.plain.vof.plic import (NEIGHBOR_OFFSETS, Plic, _div, segment_endpoints,
                                                 segment_endpoints_vals, shift)


def solve3_cramer(A, d):
    """Solve the symmetric 3x3 systems A c = d, A given as a dict of its
    upper entries ``A[(r, c)]`` and d as a list, by Cramer's rule. Singular
    systems give inf/NaN, which the caller clamps."""
    a, b, c = A[(0, 0)], A[(0, 1)], A[(0, 2)]
    e, f = A[(1, 1)], A[(1, 2)]
    i = A[(2, 2)]
    det = a * (e * i - f * f) - b * (b * i - f * c) + c * (b * f - e * c)
    d0, d1, d2 = d
    det0 = d0 * (e * i - f * f) - b * (d1 * i - f * d2) + c * (d1 * f - e * d2)
    det1 = a * (d1 * i - f * d2) - d0 * (b * i - f * c) + c * (b * d2 - d1 * c)
    det2 = a * (e * d2 - d1 * f) - b * (b * d2 - d1 * c) + d0 * (b * f - e * c)
    return det0 / det, det1 / det, det2 / det


def vm_core(nb, t_nx, t_ny, dx: float, dy: float):
    """Volume-matching fit on a 3x3 neighbourhood: ``nb[(di, dj)]`` =
    (seg_x0, seg_y0, seg_x1, seg_y1, valid) tensors of one shape. Returns
    the (0, 0) cell's curvature, masked."""
    t_x0, t_y0, t_x1, t_y1, t_valid = nb[(0, 0)]
    dtype = t_x0.dtype

    # rotation taking the target normal to (0, -1)
    angle = torch.acos(torch.clamp(-t_ny, -1.0, 1.0))
    angle = torch.where(t_nx > 0.0, 2.0 * math.pi - angle, angle)
    ca = torch.cos(angle)
    sa = torch.sin(angle)
    cx = 0.5 * (t_x0 + t_x1)
    cy = 0.5 * (t_y0 + t_y1)

    zero = torch.zeros_like(cx)
    A = {(r, c): zero for r in range(3) for c in range(r, 3)}
    dvec = [zero, zero, zero]
    count = torch.zeros(cx.shape, dtype=torch.int32, device=cx.device)
    for di, dj in NEIGHBOR_OFFSETS:
        xs0, ys0, xs1, ys1, m = nb[(di, dj)]
        xs0 = xs0 + di * dx - cx
        ys0 = ys0 + dj * dy - cy
        xs1 = xs1 + di * dx - cx
        ys1 = ys1 + dj * dy - cy
        rx0 = ca * xs0 - sa * ys0
        ry0 = sa * xs0 + ca * ys0
        rx1 = ca * xs1 - sa * ys1
        ry1 = sa * xs1 + ca * ys1
        swap = rx0 > rx1
        bx = torch.where(swap, rx1, rx0)
        by = torch.where(swap, ry1, ry0)
        ex = torch.where(swap, rx0, rx1)
        ey = torch.where(swap, ry0, ry1)
        # masked-out cells get a dummy unit segment (0 * NaN != 0)
        bx = torch.where(m, bx, zero)
        by = torch.where(m, by, zero)
        ex = torch.where(m, ex, torch.ones_like(ex))
        ey = torch.where(m, ey, zero)

        b1 = (ey - by) / (ex - bx)
        b0 = by - b1 * bx
        S = [ex - bx, 0.5 * (ex * ex - bx * bx), _div(ex * ex * ex - bx * bx * bx, 3.0)]
        w = m.to(dtype)
        for r in range(3):
            for c in range(r, 3):
                A[(r, c)] = A[(r, c)] + w * S[r] * S[c]
        rhs_r = b0 * S[0] + b1 * S[1]
        for r in range(3):
            dvec[r] = dvec[r] + w * S[r] * rhs_r
        count = count + m.to(torch.int32)

    _, c1, c2 = solve3_cramer(A, dvec)
    curv = 2.0 * c2 / torch.pow(1.0 + c1 * c1, 1.5)
    curv = torch.where(torch.isfinite(curv), curv, zero)
    return torch.where(t_valid & (count > 1), curv, zero)


def curvature_quad_volume_matching(vf_old: torch.Tensor, rec: Plic, grid: Grid) -> torch.Tensor:
    """Curvature over the full ghost box: interior mixed cells, 0 elsewhere
    (``vm_core`` on the shifted interior views of the segment endpoints)."""
    seg = segment_endpoints_vals(rec.nx, rec.ny, rec.d, grid.dx, grid.dy)
    nb = {(di, dj): tuple(shift(f, di, dj) for f in (*seg, rec.valid))
          for di, dj in NEIGHBOR_OFFSETS}
    return pad_interior(vm_core(nb, shift(rec.nx, 0, 0), shift(rec.ny, 0, 0), grid.dx, grid.dy))


def curvature_quad_regression(vf_old: torch.Tensor, rec: Plic, grid: Grid) -> torch.Tensor:
    """Least-squares quadratic y = c0 + c1 x + c2 x^2 through the 3x3
    neighbourhood's segment midpoints, rotated so that the cell's normal
    points to (0, -1); kappa at the cell's own midpoint. Full ghost box,
    0 off the interior mixed cells."""
    dx, dy = grid.dx, grid.dy
    x0, y0, x1, y1 = segment_endpoints(rec, dx, dy)
    t_nx, t_ny, t_valid = shift(rec.nx, 0, 0), shift(rec.ny, 0, 0), shift(rec.valid, 0, 0)
    angle = torch.acos(torch.clamp(-t_ny, -1.0, 1.0))
    angle = torch.where(t_nx > 0.0, 2.0 * math.pi - angle, angle)
    ca, sa = torch.cos(angle), torch.sin(angle)
    cx = 0.5 * (shift(x0, 0, 0) + shift(x1, 0, 0))
    cy = 0.5 * (shift(y0, 0, 0) + shift(y1, 0, 0))

    zero = torch.zeros_like(cx)
    A = {(r, c): zero for r in range(3) for c in range(r, 3)}
    bvec = [zero, zero, zero]
    x_eval = None
    for di, dj in NEIGHBOR_OFFSETS:
        mx = 0.5 * (shift(x0, di, dj) + shift(x1, di, dj)) + di * dx - cx
        my = 0.5 * (shift(y0, di, dj) + shift(y1, di, dj)) + dj * dy - cy
        rx = ca * mx - sa * my
        ry = sa * mx + ca * my
        m = shift(rec.valid, di, dj)
        rx = torch.where(m, rx, zero)
        ry = torch.where(m, ry, zero)
        if di == 0 and dj == 0:
            x_eval = rx
        w = m.to(cx.dtype)
        P = [torch.ones_like(rx), rx, rx * rx]
        for r in range(3):
            for c in range(r, 3):
                A[(r, c)] = A[(r, c)] + w * P[r] * P[c]
            bvec[r] = bvec[r] + w * P[r] * ry

    _, c1, c2 = solve3_cramer(A, bvec)
    first = c1 + 2.0 * c2 * x_eval
    curv = 2.0 * c2 / torch.pow(1.0 + first * first, 1.5)
    curv = torch.where(torch.isfinite(curv), curv, zero)
    curv = torch.where(t_valid, curv, zero)
    return torch.nn.functional.pad(curv, (1, 1, 1, 1))


N_SMOOTH = 4  # the smoothing kernel's half-width in cells


def _smoothing_kernel(dx: float, dy: float) -> np.ndarray:
    """w(r) = (1 - (r/L)^2)^4 on the (2n+1)^2 stencil, L = n max(dx, dy)."""
    length = N_SMOOTH * max(dx, dy)
    offs = np.arange(-N_SMOOTH, N_SMOOTH + 1)
    KX, KY = np.meshgrid(offs * dx, offs * dy, indexing="ij")
    q = (KX**2 + KY**2) / length**2
    return np.where(q < 1.0, (1.0 - q) ** 4, 0.0)


@functools.lru_cache(maxsize=16)
def _cell_origins(grid: Grid, dtype: torch.dtype, device: torch.device):
    """The lower-left corners' x and y of every cell of the ghost box, made
    once per grid, dtype and device so that no step copies from the host."""
    return (torch.as_tensor(grid.x[:-1], dtype=dtype, device=device),
            torch.as_tensor(grid.y[:-1], dtype=dtype, device=device))


def curvature_convolved_vf(vf_old: torch.Tensor, rec: Plic, grid: Grid,
                           interpolate: bool = True) -> torch.Tensor:
    """Convolved-vf curvature (Cummins, Francois and Kothe 2005): the
    interior of vf smoothed with the compact kernel (neighbours beyond the
    interior skipped), then kappa = -div(grad/|grad|) from centred
    differences, bilinearly sampled at the segment midpoint (or at the
    cell centre without ``interpolate``); 0 off the mixed cells."""
    dx, dy = grid.dx, grid.dy
    ker = _smoothing_kernel(dx, dy)
    n = N_SMOOTH
    padded = torch.nn.functional.pad(vf_old[1:-1, 1:-1], (n, n, n, n))
    nx, ny = grid.nx, grid.ny
    smooth = torch.zeros_like(vf_old[1:-1, 1:-1])
    for a in range(2 * n + 1):
        for b in range(2 * n + 1):
            if ker[a, b] != 0.0:
                smooth = smooth + float(ker[a, b]) * padded[a:a + nx, b:b + ny]
    vf_smooth = torch.nn.functional.pad(smooth, (1, 1, 1, 1))

    dvfdx, dvfdy = grad_centered(vf_smooth, dx, dy)
    dxx, dxy = grad_centered(dvfdx, dx, dy)
    _, dyy = grad_centered(dvfdy, dx, dy)
    numer = dxx * dvfdy**2 + dyy * dvfdx**2 - 2.0 * dvfdx * dvfdy * dxy
    denom = torch.pow(dvfdx**2 + dvfdy**2, 1.5)
    zero = torch.zeros_like(denom)
    curv_c = torch.where(torch.abs(denom) > 1e-8,
                         -numer / torch.where(denom == 0.0, torch.ones_like(denom), denom), zero)
    if not interpolate:
        return torch.where(rec.valid, curv_c, zero)

    x0, y0, x1, y1 = segment_endpoints(rec, dx, dy)
    X0, Y0 = _cell_origins(grid, vf_old.dtype, vf_old.device)
    mx = 0.5 * (x0 + x1) + X0[:, None]
    my = 0.5 * (y0 + y1) + Y0[None, :]
    sampled = sample_centered(curv_c, float(grid.xm[1]), dx, float(grid.ym[1]), dy, mx, my)
    return torch.where(rec.valid, sampled, zero)
