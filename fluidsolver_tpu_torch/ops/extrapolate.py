"""Divergence-free velocity extrapolation: port of
``fluidsolver_tpu.ops.extrapolate``.

1. ``constant_extrapolate``: fill unknown staggered values by repeated
   nearest-neighbour averaging over values already available (known
   values are pinned).
2. ``project_div_free``: one masked pressure projection: solve
   ``-div(mask * grad(phi)) = -div(U)`` by CG where only the unknown faces
   are correctable, then ``U -= mask_u * dphi/dx`` (the same for V). Every
   cell touching an unknown face ends divergence-free to the CG tolerance;
   the known faces are never modified.

The JAX package runs the CG in ``lax.while_loop``; here it is a Python loop
whose exit test reads one device scalar per iteration (``core.sync.read``),
as ``poisson/cg.py`` does.
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.ops import stencil


def _shift_sum(a):
    """The sum of each entry's four axis neighbours (zero outside)."""
    s = torch.zeros_like(a)
    s[1:, :] += a[:-1, :]
    s[:-1, :] += a[1:, :]
    s[:, 1:] += a[:, :-1]
    s[:, :-1] += a[:, 1:]
    return s


def constant_extrapolate(f: torch.Tensor, known: torch.Tensor, n_sweeps: int):
    """Fill ``f`` where ``~known`` by iterated 4-neighbour averaging over
    values already available; known entries never change. ``n_sweeps``
    bounds the fill distance (one cell a sweep): use >= max(nx, ny) to
    cover the box from any seed region."""
    known = known.to(f.dtype)
    g = f * known  # unknown entries contribute 0
    avail = known
    for _ in range(n_sweeps):
        nb_sum = _shift_sum(g * avail)
        nb_cnt = _shift_sum(avail)
        fill = nb_sum / torch.where(nb_cnt > 0, nb_cnt, torch.ones_like(nb_cnt))
        g = torch.where(known > 0, g, torch.where(nb_cnt > 0, fill, g))
        avail = torch.maximum(avail, (nb_cnt > 0).to(avail.dtype))
    return g


def project_div_free(U, V, known_u, known_v, grid: Grid, tol: float = 1e-10,
                     max_iter: int = 2000, seal_boundary: bool = False):
    """Correct the unknown faces of (U, V) so that every cell with an
    unknown face becomes divergence-free; known faces are untouched.
    Returns ``(U, V, rel_residual, iters)`` (``iters`` an int).

    ``seal_boundary=False``: unknown faces on the domain boundary are
    correctable too (mass may leave the box; the masked operator is SPD).
    ``seal_boundary=True``: boundary faces are pinned; the operator is then
    singular and its constant nullspace is projected out."""
    dx, dy = grid.dx, grid.dy
    mask_u = 1.0 - known_u.to(U.dtype)
    mask_v = 1.0 - known_v.to(V.dtype)
    # ghost faces are never corrected; boundary faces only if not sealed
    b_lo = 2 if seal_boundary else 1
    mask_u[:b_lo, :] = 0.0
    mask_u[-b_lo:, :] = 0.0
    mask_u[:, 0] = 0.0
    mask_u[:, -1] = 0.0
    mask_v[:, :b_lo] = 0.0
    mask_v[:, -b_lo:] = 0.0
    mask_v[0, :] = 0.0
    mask_v[-1, :] = 0.0

    # active rows: interior cells next to a correctable face
    touch = (mask_u[1:, :] > 0) | (mask_u[:-1, :] > 0) | (mask_v[:, 1:] > 0) | (mask_v[:, :-1] > 0)
    interior = torch.zeros_like(touch)
    interior[1:-1, 1:-1] = True
    active = touch & interior

    def A(phi):
        fx = mask_u[1:-1, :] * (phi[1:, :] - phi[:-1, :]) / dx  # interior u faces
        fy = mask_v[:, 1:-1] * (phi[:, 1:] - phi[:, :-1]) / dy
        lap = torch.zeros_like(phi)
        lap[1:-1, :] += (fx[1:, :] - fx[:-1, :]) / dx
        lap[:, 1:-1] += (fy[:, 1:] - fy[:, :-1]) / dy
        return torch.where(active, -lap, phi)

    def proj(v):
        # sealed: remove the constant nullspace over the active set (v
        # vanishes off it, so sum(v) is the active sum)
        if not seal_boundary:
            return v
        n_act = torch.clamp(torch.sum(active), min=1)
        return torch.where(active, v - torch.sum(v) / n_act, v)

    div = stencil.divergence(U, V, dx, dy)
    b = proj(torch.where(active, -div, torch.zeros_like(div)))
    b_norm = torch.sqrt(torch.sum(b * b))
    safe = torch.where(b_norm > 0, b_norm, torch.ones_like(b_norm))

    phi, r, p = torch.zeros_like(b), b, b
    rs = torch.sum(b * b)
    k = 0
    while k < max_iter and sync.read(torch.sqrt(rs) / safe > tol):
        Ap = proj(A(p))
        alpha = rs / torch.sum(p * Ap)
        phi = phi + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / rs) * p
        rs = rs_new
        k += 1
    rel = torch.sqrt(rs) / safe

    U = U.clone()
    V = V.clone()
    U[1:-1, :] += -mask_u[1:-1, :] * (phi[1:, :] - phi[:-1, :]) / dx
    V[:, 1:-1] += -mask_v[:, 1:-1] * (phi[:, 1:] - phi[:, :-1]) / dy
    return U, V, rel, k


def div_free_extrapolate(U, V, known_u, known_v, grid: Grid, n_sweeps: int = None,
                         tol: float = 1e-10, max_iter: int = 2000, seal_boundary: bool = False):
    """Extrapolate (U, V) from the known faces outward, divergence-free:
    constant extrapolation seeds the unknown faces, one masked projection
    makes them solenoidal. Returns ``(U, V, rel_residual, iters)``."""
    if n_sweeps is None:
        n_sweeps = max(U.shape[0], U.shape[1])
    U = constant_extrapolate(U, known_u, n_sweeps)
    V = constant_extrapolate(V, known_v, n_sweeps)
    return project_div_free(U, V, known_u, known_v, grid, tol, max_iter, seal_boundary)
