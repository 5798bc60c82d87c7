"""Interface curvature from PLIC segments: port of the volume-matching
method of ``fluidsolver_tpu.vof.curvature``.

For each interior mixed cell the 3x3 neighbourhood's PLIC segments are
rotated so that the cell's normal points to (0, -1) about its segment
midpoint, y = c0 + c1 x + c2 x^2 is fitted by matching the segments'
integrals in the least-squares sense (a symmetric 3x3 system solved by
Cramer's rule), and kappa = 2 c2 / (1 + c1^2)^(3/2); non-finite values and
cells with fewer than two segments give 0. ``curvature_quad_volume_matching``
runs kernel #11 (``vof/cuda_curvature.py``) on a CUDA tensor.

The regression and convolved-vf methods are not ported.
"""

from __future__ import annotations

import math

import torch

from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.vof.plic import NEIGHBOR_OFFSETS, Plic, _div


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
    """Curvature over the full ghost box: interior mixed cells, 0 elsewhere."""
    from fluidsolver_tpu_torch.vof import cuda_curvature

    return cuda_curvature.curvature_vm(rec.nx, rec.ny, rec.d, rec.valid, grid.dx, grid.dy)
