"""BiCGSTAB, restarted GMRES and MG-as-solver for the pressure system: port
of ``fluidsolver_tpu.poisson.krylov``, the rest of the reference's HYPRE
solver enum {GMRES, PCG, BiCGSTAB, SMG/PFMG} (PCG lives in ``cg.py``).

- ``solve_bicgstab``: preconditioned BiCGSTAB;
- ``solve_gmres``: restarted, right-preconditioned GMRES(m) with the true
  residual recomputed at every restart;
- ``solve_mg``: the V-cycle iterated as the solver.

Conventions are ``cg.solve_pcg``'s: the relative two-norm ||b - A x|| / ||b||
< tol stops the loop; the singular all-Neumann system has the constant
nullspace projected out of b, the iterates and every preconditioned vector;
a non-finite or broken-down iteration is rejected and the loop exits with
the last good iterate (NaN > tol is False, which would falsely signal
convergence). The JAX package runs each loop as ``lax.while_loop``; here it
is a Python loop whose test reads one device scalar per iteration through
``core.sync.read`` (GMRES: one per Arnoldi step and one per restart).
Scalars stay 0-d device tensors; iteration counts are host ints.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.poisson.linsys import StencilOp, apply_op


def _dot(a, b):
    return torch.sum(a * b)


def _norm(a):
    return torch.sqrt(_dot(a, a))


def _nonzero(d):
    """``d`` where it is not 0, else 1 (a guarded divisor)."""
    return torch.where(d != 0.0, d, torch.ones_like(d))


def _prepare(op: StencilOp, b, singular: bool, x0):
    """Shared setup: project b and form the warm-started residual; a guess
    whose residual is not below ||b|| is replaced by zero."""
    def project(v):
        return v - torch.mean(v) if singular else v

    b = project(b)
    b_norm = _norm(b)
    safe_b_norm = torch.where(b_norm > 0.0, b_norm, torch.ones_like(b_norm))
    if x0 is None:
        x0, r0 = torch.zeros_like(b), b
    else:
        x0 = project(x0.to(b.dtype))
        r_ws = b - apply_op(op, x0)
        good = _dot(r_ws, r_ws) < _dot(b, b)
        x0 = torch.where(good, x0, torch.zeros_like(b))
        r0 = torch.where(good, r_ws, b)
    return project, b, b_norm, safe_b_norm, x0, r0


def solve_bicgstab(op: StencilOp, b, tol: float, max_iter: int, singular: bool,
                   M_inv: Callable, x0: Optional[torch.Tensor] = None):
    """Preconditioned BiCGSTAB (van der Vorst 1992). Returns ``(x,
    rel_residual, iterations)``. One iteration = 2 operator and 2
    preconditioner applications."""
    project, b, b_norm, safe_b_norm, x, r = _prepare(op, b, singular, x0)
    rhat = r  # fixed shadow residual
    rel = _norm(r) / safe_b_norm
    p = v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iter and sync.read((rel > tol) & (b_norm > 0.0) & ~done):
        rho_new = _dot(rhat, r)
        beta = (rho_new / _nonzero(rho)) * (alpha / _nonzero(omega))
        p_new = r + beta * (p - omega * v)
        phat = project(M_inv(p_new))
        v_new = apply_op(op, phat)
        denom = _dot(rhat, v_new)
        alpha_new = rho_new / _nonzero(denom)
        s = r - alpha_new * v_new
        shat = project(M_inv(s))
        t = apply_op(op, shat)
        tt = _dot(t, t)
        omega_new = _dot(t, s) / _nonzero(tt)
        x_new = x + alpha_new * phat + omega_new * shat
        r_new = s - omega_new * t
        rel_new = _norm(r_new) / safe_b_norm
        # breakdown / overflow guard: keep the last good iterate and exit
        ok = (torch.isfinite(rel_new) & torch.isfinite(rho_new) & (torch.abs(rho_new) > 0.0)
              & (torch.abs(denom) > 0.0) & (tt > 0.0))
        x, r, rel = torch.where(ok, x_new, x), torch.where(ok, r_new, r), torch.where(ok, rel_new, rel)
        p, v = torch.where(ok, p_new, p), torch.where(ok, v_new, v)
        rho, alpha = torch.where(ok, rho_new, rho), torch.where(ok, alpha_new, alpha)
        omega = torch.where(ok, omega_new, omega)
        done = ~ok
        k += 1
    return project(x), rel, k


def solve_gmres(op: StencilOp, b, tol: float, max_iter: int, singular: bool, M_inv: Callable,
                restart: int = 20, x0: Optional[torch.Tensor] = None):
    """Restarted right-preconditioned GMRES(m) with a Givens-rotation QR of
    the Hessenberg matrix. Returns ``(x, rel_residual, iterations)``.

    Right preconditioning keeps the monitored quantity the true residual
    norm; the true residual is recomputed at every restart, so rounding
    drift cannot fake convergence. ``max_iter`` caps the Arnoldi steps over
    all restarts; a cycle that does not lower the residual ends the solve."""
    project, b, b_norm, safe_b_norm, x, r0 = _prepare(op, b, singular, x0)
    m = int(restart)
    shape, n = b.shape, b.numel()
    rel = _norm(r0) / safe_b_norm
    stalled = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iter and sync.read((rel > tol) & (b_norm > 0.0) & ~stalled):
        r = b - apply_op(op, x)  # true residual at each restart
        beta = _norm(r)
        V = b.new_zeros((m + 1, n))
        V[0] = (r / torch.where(beta > 0.0, beta, torch.ones_like(beta))).reshape(-1)
        H = b.new_zeros((m + 1, m))
        cs, sn = b.new_zeros(m), b.new_zeros(m)
        g = b.new_zeros(m + 1)
        g[0] = beta
        j = 0
        # grow the space while the rotated residual |g[j]| is above tol, the
        # space is not full and the budget is not spent
        while j < m and k + j < max_iter and sync.read(torch.abs(g[j]) / safe_b_norm > tol):
            w = apply_op(op, project(M_inv(V[j].reshape(shape)))).reshape(-1)
            # Gram-Schmidt against the basis so far (rows > j are zero)
            hcol = V @ w
            hcol[j + 1:] = 0.0
            w = w - hcol @ V
            h_next = torch.sqrt(torch.sum(w * w))
            V[j + 1] = w / torch.where(h_next > 0.0, h_next, torch.ones_like(h_next))
            # the accumulated Givens rotations, then a new one for col[j+1]
            col = hcol.clone()
            col[j + 1] = h_next
            for i in range(j):
                a, bb = col[i].clone(), col[i + 1].clone()
                col[i] = cs[i] * a + sn[i] * bb
                col[i + 1] = -sn[i] * a + cs[i] * bb
            denom = torch.sqrt(col[j] ** 2 + col[j + 1] ** 2)
            pos = denom > 0.0
            safe = torch.where(pos, denom, torch.ones_like(denom))
            c_new = torch.where(pos, col[j] / safe, torch.ones_like(denom))
            s_new = torch.where(pos, col[j + 1] / safe, torch.zeros_like(denom))
            cs[j], sn[j] = c_new, s_new
            col[j] = c_new * col[j] + s_new * col[j + 1]
            col[j + 1] = 0.0
            H[:, j] = col
            gj = g[j].clone()
            g[j] = c_new * gj
            g[j + 1] = -s_new * gj
            j += 1

        # back substitution on the j x j upper-triangular system
        y = b.new_zeros(m)
        for i in range(j - 1, -1, -1):
            hii = H[i, i]
            y[i] = (g[i] - torch.dot(H[i, :], y)) / torch.where(hii != 0.0, hii, torch.ones_like(hii))
        x_new = x + project(M_inv((y @ V[:m]).reshape(shape)))
        # a broken (non-finite) cycle keeps the previous iterate
        x_new = torch.where(torch.all(torch.isfinite(x_new)), x_new, x)
        rel_new = _norm(b - apply_op(op, x_new)) / safe_b_norm
        # a cycle that makes no progress (singular or stagnated) must not spin
        better = rel_new < rel
        stalled = rel_new >= rel if j > 0 else torch.ones_like(better)
        x, rel = torch.where(better, x_new, x), torch.where(better, rel_new, rel)
        k += j
    return project(x), rel, k


def solve_mg(op: StencilOp, b, tol: float, max_iter: int, singular: bool, M_inv: Callable,
             x0: Optional[torch.Tensor] = None):
    """Stationary multigrid iteration ``x <- x + V(b - A x)`` until the
    relative residual drops below tol (HYPRE's SMG/PFMG used as the
    solver). ``M_inv`` is one V-cycle (``cg.make_m_inv`` with "mg" or
    "boxmg"). A cycle that does not lower the residual, or a non-finite
    one, is rejected and ends the solve."""
    project, b, b_norm, safe_b_norm, x, r = _prepare(op, b, singular, x0)
    rel = _norm(r) / safe_b_norm
    done = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < max_iter and sync.read((rel > tol) & (b_norm > 0.0) & ~done):
        x_new = project(x + project(M_inv(r)))
        r_new = b - apply_op(op, x_new)
        rel_new = _norm(r_new) / safe_b_norm
        ok = torch.isfinite(rel_new) & (rel_new < rel)
        x, r, rel = torch.where(ok, x_new, x), torch.where(ok, r_new, r), torch.where(ok, rel_new, rel)
        done = ~ok
        k += 1
    return project(x), rel, k
