"""Preconditioned conjugate gradients for the pressure Poisson solve: port
of ``fluidsolver_tpu.poisson.cg``. The preconditioner is one V-cycle of the
geometric multigrid ("mg", ``poisson/mg.py``, the HYPRE PCG + PFMG analog
and the default) or of BoxMG ("boxmg", ``poisson/boxmg.py``), the diagonal
("jacobi") or none.

Convergence criterion: relative two-norm ||r||/||b|| < tol. For the
singular all-Neumann system the preconditioned direction and the iterate
are kept orthogonal to the constant nullspace by mean subtraction.

The JAX package runs the loop as ``lax.while_loop``; here it is a Python
loop whose test reads one device scalar per iteration (``core.sync.read``).

The work of an iteration outside the preconditioner runs as kernels 5-7
(``poisson/cuda_cg.py``): ``step_init`` and ``step_c``'s init form before
the loop, ``step_ab`` and ``step_c`` in it, as the JAX package's fused
branch (``FS_PALLAS_CG``) has them. On CPU tensors they run their twins.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch
from torch.profiler import record_function

from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.poisson import boxmg, cuda_cg, mg
from fluidsolver_tpu_torch.poisson.linsys import StencilOp

_MG = {"mg": mg, "boxmg": boxmg}
# the profiler range of an iteration's guard selects and bookkeeping, opened
# only while a profiler records (a range costs about as much host time as a
# tensor operation)
GUARD_RANGE = "pcg.guards"


def build_precond_levels(op: StencilOp, precond: str):
    """The multigrid hierarchy for ``precond`` "mg" or "boxmg"; None for
    the others. Solvers build it once and reuse it over several solves."""
    return _MG[precond].build_hierarchy(op) if precond in _MG else None


def make_m_inv(op: StencilOp, precond: str, levels=None, n_pre: int = 1, n_post: int = 1):
    """``(M_inv, levels)``: the preconditioner ``r -> z`` for ``precond`` in
    {"mg", "boxmg", "jacobi", "none"} and its hierarchy (built here for
    "mg"/"boxmg" unless given, else None). Shared by PCG and
    ``poisson/krylov.py``."""
    if precond in _MG:
        if levels is None:
            levels = build_precond_levels(op, precond)

        def M_inv(r):
            return _MG[precond].v_cycle(levels, r, n_pre=n_pre, n_post=n_post)
    elif precond == "jacobi":
        aC_safe = torch.where(op.aC == 0.0, torch.ones_like(op.aC), op.aC)

        def M_inv(r):
            return r / aC_safe
    elif precond == "none":
        def M_inv(r):
            return r
    else:
        raise ValueError(f"unknown preconditioner: {precond}")
    return M_inv, levels


def solve_pcg(op: StencilOp, b: torch.Tensor, tol: float, max_iter: int, singular: bool,
              precond: str = "mg", n_pre: int = 1, n_post: int = 1,
              x0: Optional[torch.Tensor] = None, levels=None):
    """Solve A x = b from zero (or the warm start ``x0``).

    Returns (x, rel_residual, iterations): ``rel_residual`` a 0-d tensor,
    ``iterations`` an int. The warm start is guarded (discarded if
    ||b - A x0|| >= ||b||). The loop stops at ``tol``, at ``max_iter``, on a
    stagnation window (no 0.01% improvement for STAG_WINDOW iterations),
    or on a breakdown (non-positive pAp or a non-finite value), and returns
    the best iterate seen.

    The JAX package reaches its fused init (``step_init``) only under its
    TPU band layout, which is not ported; here every solve starts with
    ``step_init``."""
    M_inv, _ = make_m_inv(op, precond, levels=levels, n_pre=n_pre, n_post=n_post)

    def project(v):
        return v - torch.mean(v) if singular else v

    # f32 recurrences hit a rounding floor that can sit above tol: stop
    # once the residual has stalled for STAG_WINDOW iterations
    STAG_WINDOW = 25 if torch.finfo(b.dtype).bits <= 32 else 100

    x, r, bb, rr, sum_r = cuda_cg.step_init(op, b, None if x0 is None else x0.to(b.dtype), singular)
    b_norm = torch.sqrt(bb)
    safe_b_norm = torch.where(b_norm > 0.0, b_norm, torch.ones_like(b_norm))
    rel = torch.sqrt(rr) / safe_b_norm
    _, p, rz = cuda_cg.step_c(r, M_inv(r), None, torch.ones_like(bb), singular, sum_r=sum_r)
    best = rel
    since = torch.zeros((), dtype=torch.int32, device=b.device)
    x_best = x

    k = 0
    while k < max_iter:
        if not sync.read((rel > tol) & (b_norm > 0.0) & (since < STAG_WINDOW)):
            break
        x_new, r_new, pAp, rr, sum_r = cuda_cg.step_ab(op, x, r, p, rz)
        _, p_new, rz_new = cuda_cg.step_c(r_new, M_inv(r_new), p, rz, singular, sum_r=sum_r)
        with record_function(GUARD_RANGE) if torch.autograd._profiler_enabled() else nullcontext():
            rel_new = torch.sqrt(rr) / safe_b_norm
            # breakdown guard: reject the update, keep the last good iterate
            # and trip the stagnation exit
            ok = (pAp > 0.0) & torch.isfinite(rel_new) & torch.isfinite(rz_new)
            x = torch.where(ok, x_new, x)
            r = torch.where(ok, r_new, r)
            p = torch.where(ok, p_new, p)
            rz = torch.where(ok, rz_new, rz)
            rel = torch.where(ok, rel_new, rel)
            improved = ok & (rel < best * 0.9999)
            best = torch.minimum(best, rel)
            since = torch.where(improved, torch.zeros_like(since),
                                torch.where(ok, since + 1, torch.full_like(since, STAG_WINDOW)))
            x_best = torch.where(rel <= best, x, x_best)
        k += 1
    return project(x_best), best, k
