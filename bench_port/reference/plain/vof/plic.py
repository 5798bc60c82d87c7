"""PLIC geometry: port of ``fluidsolver_tpu.vof.plic``.

Per-cell local coordinates have their origin at the cell's lower-left
corner; the liquid region of a cell is {p : n . p <= d} with |n| = 1. All
fields span the full ghost box (nx+2, ny+2); a reconstruction exists only
where ``valid`` is set (interior mixed cells).

``elvira`` runs the 12-candidate ELVIRA search on every cell (the port's
kernel #10) and leaves the fills (0, 1, 0) on every cell that
is not interior-mixed, as the JAX package's sparse path and its TPU kernel
do. The mixed set is never compacted here, so there is no lane budget and
``Plic.overflow`` is always False; the advection keeps its own budget.

The plain versions below are the twins of the kernels: they repeat the JAX
package's expressions in its operand order. A Python-float divisor is
turned into a 0-d tensor (``_div``): on CUDA, PyTorch divides by a Python
scalar as a multiplication by its reciprocal, which the kernels do not do.
"""

from __future__ import annotations

import dataclasses

import torch

from bench_port.reference.plain.constants import vf_cutoffs

_DEG_EPS = 1e-12  # relative threshold for an axis-aligned normal component
NEIGHBOR_OFFSETS = [(di, dj) for di in (-1, 0, 1) for dj in (-1, 0, 1)]


@dataclasses.dataclass
class Plic:
    """Per-cell planar interface: liquid = {p : nx*p_x + ny*p_y <= d} in
    cell-local coordinates. ``overflow``: 0-d bool tensor, the
    reconstruction ran out of lanes (never, for the dense kernel)."""

    nx: torch.Tensor
    ny: torch.Tensor
    d: torch.Tensor
    valid: torch.Tensor
    overflow: torch.Tensor


def _div(x: torch.Tensor, s: float) -> torch.Tensor:
    """``x / s`` as an elementwise true division by the Python float ``s``."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def _where(cond, a, b, like=None):
    """``torch.where`` that takes Python floats for either branch (both, if
    ``like`` gives the dtype and shape)."""
    if like is None:
        like = a if isinstance(a, torch.Tensor) else b
    if not isinstance(a, torch.Tensor):
        a = torch.full_like(like, a)
    if not isinstance(b, torch.Tensor):
        b = torch.full_like(like, b)
    return torch.where(cond, a, b)


def shift(f: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """f(i+di, j+dj) over the interior cells: a (nx, ny) view of the
    ghosted (nx+2, ny+2) array."""
    return f[1 + di: f.shape[0] - 1 + di, 1 + dj: f.shape[1] - 1 + dj]


def _pos_area(a, b, c, w: float, h: float):
    """Area of {a x + b y <= c} in [0,w]x[0,h] for a,b >= 0 (possibly
    degenerate). Corner inclusion-exclusion with axis-aligned fallbacks."""
    aw = a * w
    bh = b * h
    scale = aw + bh
    a_deg = aw <= _DEG_EPS * scale
    b_deg = bh <= _DEG_EPS * scale

    ab = _where(a_deg | b_deg, 1.0, a * b)
    p0 = torch.clamp_min(c, 0.0)
    p1 = torch.clamp_min(c - aw, 0.0)
    p2 = torch.clamp_min(c - bh, 0.0)
    p3 = torch.clamp_min(c - aw - bh, 0.0)
    area_gen = (p0 * p0 - p1 * p1 - p2 * p2 + p3 * p3) / (2.0 * ab)

    safe_b = _where(b_deg, 1.0, b)
    safe_a = _where(a_deg, 1.0, a)
    area_a0 = w * torch.clamp(c / safe_b, 0.0, h)
    area_b0 = h * torch.clamp(c / safe_a, 0.0, w)
    both = a_deg & b_deg
    area_both = _where(c >= 0.0, w * h, 0.0, like=c)
    return torch.where(both, area_both,
                       torch.where(a_deg, area_a0, torch.where(b_deg, area_b0, area_gen)))


def area_fraction(nx, ny, d, w: float, h: float):
    """Fraction of the rectangle [0,w]x[0,h] covered by {nx x + ny y <= d}."""
    a = torch.abs(nx)
    b = torch.abs(ny)
    c = d - torch.clamp_max(nx, 0.0) * w - torch.clamp_max(ny, 0.0) * h
    return _div(_pos_area(a, b, c, w, h), w * h)


def plane_constant(nx, ny, frac, w: float, h: float):
    """Inverse of ``area_fraction``: the d with area_fraction(nx,ny,d,w,h)
    == frac (frac clipped to [0,1]). Exact piecewise closed form."""
    frac = torch.clamp(frac, 0.0, 1.0)
    a = torch.abs(nx)
    b = torch.abs(ny)
    aw = a * w
    bh = b * h
    scale = aw + bh
    a_deg = aw <= _DEG_EPS * scale
    b_deg = bh <= _DEG_EPS * scale

    A = frac * w * h
    n1 = torch.minimum(aw, bh)
    n2 = torch.maximum(aw, bh)
    ab = _where(a_deg | b_deg, 1.0, a * b)
    A_tri = n1 * n1 / (2.0 * ab)
    wh = w * h

    c_tri = torch.sqrt(torch.clamp_min(2.0 * ab * A, 0.0))
    safe_n1 = _where(n1 <= 0.0, 1.0, n1)
    c_mid = A * ab / safe_n1 + 0.5 * n1
    c_top = (n1 + n2) - torch.sqrt(torch.clamp_min(2.0 * ab * (wh - A), 0.0))
    c = torch.where(A <= A_tri, c_tri, torch.where(A <= wh - A_tri, c_mid, c_top))

    safe_b = _where(b_deg, 1.0, b)
    safe_a = _where(a_deg, 1.0, a)
    c = torch.where(a_deg & ~b_deg, frac * h * safe_b, c)
    c = torch.where(b_deg & ~a_deg, frac * w * safe_a, c)
    c = torch.where(a_deg & b_deg, _where(frac > 0.5, 1.0, -1.0, like=frac), c)
    return c + torch.clamp_max(nx, 0.0) * w + torch.clamp_max(ny, 0.0) * h


def has_interface(vf):
    """Mixed-cell predicate with the dtype-aware cutoffs."""
    lo, hi = vf_cutoffs(vf.dtype)
    return (vf > lo) & (vf < hi)


def _candidates(vfn, dx: float, dy: float):
    """The 12 ELVIRA candidate normals, in the JAX package's order (slopes
    of the column heights, then of the row heights; each slope with both
    orientations)."""
    col = {di: (vfn[(di, -1)] + vfn[(di, 0)] + vfn[(di, 1)]) * dy for di in (-1, 0, 1)}
    row = {dj: (vfn[(-1, dj)] + vfn[(0, dj)] + vfn[(1, dj)]) * dx for dj in (-1, 0, 1)}
    slopes_y = [_div(col[0] - col[-1], dx), _div(col[1] - col[-1], 2.0 * dx),
                _div(col[1] - col[0], dx)]
    slopes_x = [_div(row[0] - row[-1], dy), _div(row[1] - row[-1], 2.0 * dy),
                _div(row[1] - row[0], dy)]
    cands = []
    for s in slopes_y:
        norm = torch.sqrt(s * s + 1.0)
        cands += [(-s / norm, 1.0 / norm), (-s / norm, -1.0 / norm)]
    for s in slopes_x:
        norm = torch.sqrt(s * s + 1.0)
        cands += [(1.0 / norm, -s / norm), (-1.0 / norm, -s / norm)]
    return cands


def elvira_candidates(vfn, dx: float, dy: float):
    """The ELVIRA search on a 3x3 neighbourhood dict ``vfn[(di, dj)]`` of
    same-shaped tensors: the candidate with the least squared mismatch of
    the reproduced fractions wins, the first one on a tie. Returns the
    winning (nx, ny, d)."""
    vf0 = vfn[(0, 0)]
    best_err = torch.full_like(vf0, float("inf"))
    best_nx = torch.zeros_like(vf0)
    best_ny = torch.ones_like(vf0)
    best_d = torch.zeros_like(vf0)
    for cnx, cny in _candidates(vfn, dx, dy):
        d = plane_constant(cnx, cny, vf0, dx, dy)
        err = torch.zeros_like(vf0)
        for di, dj in NEIGHBOR_OFFSETS:
            d_n = d - (cnx * di * dx + cny * dj * dy)
            pred = area_fraction(cnx, cny, d_n, dx, dy)
            err = err + (pred - vfn[(di, dj)]) ** 2
        better = err < best_err
        best_err = torch.where(better, err, best_err)
        best_nx = torch.where(better, cnx, best_nx)
        best_ny = torch.where(better, cny, best_ny)
        best_d = torch.where(better, d, best_d)
    return best_nx, best_ny, best_d


def default_max_mixed(nx: int, ny: int) -> int:
    """Mixed-cell lane budget of the JAX package's sparse reconstruction
    (the advection's ``default_max_active`` rule)."""
    return min(nx * ny, max(4096, 16 * max(nx, ny)))


FILLS = (0.0, 1.0, 0.0)  # (nx, ny, d) where there is no reconstruction


def _no_overflow(vf):
    return torch.zeros((), dtype=torch.bool, device=vf.device)


def elvira(vf: torch.Tensor, dx: float, dy: float) -> Plic:
    """ELVIRA reconstruction of every interior mixed cell (the 12
    candidates of ``elvira_candidates``, masked to the interior mixed cells);
    fills (0, 1, 0) elsewhere, as the JAX package's sparse path leaves
    them."""
    vfn = {(di, dj): shift(vf, di, dj) for di, dj in NEIGHBOR_OFFSETS}
    best = elvira_candidates(vfn, dx, dy)
    mixed = has_interface(vfn[(0, 0)])
    planes = []
    for value, fill in zip(best, FILLS):
        out = torch.full_like(vf, fill)
        out[1:-1, 1:-1] = torch.where(mixed, value, torch.full_like(value, fill))
        planes.append(out)
    valid = torch.zeros(vf.shape, dtype=torch.bool, device=vf.device)
    valid[1:-1, 1:-1] = mixed
    return Plic(*planes, valid=valid, overflow=_no_overflow(vf))


def segment_endpoints_vals(pnx, pny, pd, w: float, h: float, eps_rel: float = 1e-6):
    """Intersection segment of each cell's PLIC line with its cell boundary
    in cell-local coordinates: the 4 edges are tested, and of the in-bounds
    intersections the pair with the largest separation is kept (first of
    the 6 pairs on a tie). Returns (x0, y0, x1, y1)."""
    corners = [(0.0, 0.0), (w, 0.0), (w, h), (0.0, h)]
    eps = eps_rel * max(w, h)
    big = 4.0 * (w + h)

    pts_x, pts_y, ok = [], [], []
    for k in range(4):
        x0, y0 = corners[k]
        x1, y1 = corners[(k + 1) % 4]
        d0 = pnx * x0 + pny * y0 - pd
        d1 = pnx * x1 + pny * y1 - pd
        denom = d0 - d1
        t = _where(torch.abs(denom) > 1e-300, d0 / _where(denom == 0.0, 1.0, denom), big)
        px = x0 + t * (x1 - x0)
        py = y0 + t * (y1 - y0)
        pts_x.append(px)
        pts_y.append(py)
        ok.append((px >= -eps) & (px <= w + eps) & (py >= -eps) & (py <= h + eps))

    best = None
    for a in range(4):
        for b in range(a + 1, 4):
            d2 = (pts_x[a] - pts_x[b]) ** 2 + (pts_y[a] - pts_y[b]) ** 2
            d2 = _where(ok[a] & ok[b], d2, -1.0)
            cand = (d2, pts_x[a], pts_y[a], pts_x[b], pts_y[b])
            if best is None:
                best = cand
            else:
                better = d2 > best[0]
                best = tuple(torch.where(better, c, bc) for c, bc in zip(cand, best))
    return best[1:]


def segment_endpoints(plic: Plic, w: float, h: float, eps_rel: float = 1e-6):
    return segment_endpoints_vals(plic.nx, plic.ny, plic.d, w, h, eps_rel)


def interface_length(plic: Plic, w: float, h: float):
    """Per-cell PLIC segment length; 0 where there is no reconstruction."""
    x0, y0, x1, y1 = segment_endpoints(plic, w, h)
    length = torch.sqrt((x1 - x0) ** 2 + (y1 - y0) ** 2)
    return torch.where(plic.valid, length, torch.zeros_like(length))
