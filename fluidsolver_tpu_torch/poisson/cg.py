"""Preconditioned conjugate gradients for the pressure Poisson solve: port
of ``fluidsolver_tpu.poisson.cg``. The preconditioner is one V-cycle of the
geometric multigrid ("mg", ``poisson/mg.py``, the HYPRE PCG + PFMG analog
and the default) or of BoxMG ("boxmg", ``poisson/boxmg.py``), the diagonal
("jacobi") or none.

``precond_dtype`` (bf16) runs the V-cycle on a hierarchy stored in a
narrower dtype than the CG iteration (the JAX package's ``precond_dtype``):
BoxMG's is built at full precision and cast (``boxmg.cast_hierarchy``), the
"mg" hierarchy is built from the operator cast to it. The cycle's output is
cast back to the residual's dtype and its non-finite values are zeroed on
the device.

Convergence criterion: relative two-norm ||r||/||b|| < tol. For the
singular all-Neumann system the preconditioned direction and the iterate
are kept orthogonal to the constant nullspace by mean subtraction.

The JAX package runs the loop as ``lax.while_loop``; here it is a Python
loop whose test reads one device scalar per iteration (``core.sync.read``).

The work of an iteration outside the preconditioner runs as kernels 5-7
(``poisson/cuda_cg.py``): ``step_init`` and ``step_c``'s init form before
the loop, ``step_ab`` and ``step_c`` in it, as the JAX package's fused
branch (``FS_PALLAS_CG``) has them. On CPU tensors they run their twins.

Profiler ranges (``utils.profiling.annotate``): ``HIERARCHY_RANGE`` around
each hierarchy build, ``SOLVE_RANGE`` around a PCG solve from its first
kernel to its return, and inside it ``GUARD_RANGE`` around each
iteration's guards (and ``boxmg.v_cycle``'s smoothing ranges).
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.poisson import _kernels, boxmg, cuda_cg, mg
from fluidsolver_tpu_torch.poisson.linsys import StencilOp
from fluidsolver_tpu_torch.utils import profiling

_MG = {"mg": mg, "boxmg": boxmg}
HIERARCHY_RANGE = "pcg.hierarchy"
SOLVE_RANGE = "pcg.solve"
# an iteration's guard selects and bookkeeping
GUARD_RANGE = "pcg.guards"


def build_precond_levels(op: StencilOp, precond: str, precond_dtype=None):
    """The multigrid hierarchy for ``precond`` "mg" or "boxmg"; None for
    the others. Solvers build it once and reuse it over several solves.
    ``precond_dtype`` (a torch dtype or its name): the hierarchy's storage
    dtype, if it differs from the operator's."""
    if precond not in _MG:
        return None
    with profiling.annotate(HIERARCHY_RANGE):
        if precond_dtype is not None:
            precond_dtype = _kernels.torch_dtype(precond_dtype)
            if precond_dtype != op.aC.dtype:
                if precond == "boxmg":
                    # built at full precision and rounded once
                    return boxmg.cast_hierarchy(boxmg.build_hierarchy(op, tail=False), precond_dtype)
                op = boxmg.cast_struct(op, precond_dtype)
        return _MG[precond].build_hierarchy(op)


def _levels_dtype(levels) -> torch.dtype:
    first = levels[0]
    return (first.op if isinstance(first, boxmg.BoxLevel) else first).aC.dtype


def make_m_inv(op: StencilOp, precond: str, levels=None, n_pre: int = 1, n_post: int = 1,
               precond_dtype=None):
    """``(M_inv, levels)``: the preconditioner ``r -> z`` for ``precond`` in
    {"mg", "boxmg", "jacobi", "none"} and its hierarchy (built here for
    "mg"/"boxmg" unless given, else None; in ``precond_dtype`` if given).
    Shared by PCG and ``poisson/krylov.py``."""
    if precond in _MG:
        if levels is None:
            levels = build_precond_levels(op, precond, precond_dtype)
        lvl_dtype = _levels_dtype(levels)

        def M_inv(r):
            if lvl_dtype == r.dtype:
                return _MG[precond].v_cycle(levels, r, n_pre=n_pre, n_post=n_post)
            z = _MG[precond].v_cycle(levels, r.to(lvl_dtype), n_pre=n_pre, n_post=n_post)
            # a narrow cycle can overflow on an extreme operator: a zeroed
            # direction wastes the iteration, where a NaN would poison x
            return torch.nan_to_num(z.to(r.dtype), nan=0.0, posinf=0.0, neginf=0.0)
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


class Guards:
    """The exit test, breakdown guard and best-iterate bookkeeping of a PCG
    loop, shared by :func:`solve_pcg` and the distributed PCG
    (``parallel/dist_poisson.py``). ``rel``: the initial relative residual
    (0-d); ``x``: the initial iterate; ``select(ok, new, old)`` takes
    ``new`` where the 0-d ``ok`` holds (``torch.where`` on one device, slab
    by slab on a mesh). The warm-start test is not here: the single-device
    solve makes it in kernel #7 (``cuda_cg.step_init``)."""

    def __init__(self, rel, b_norm, x, select=torch.where):
        # f32 recurrences hit a rounding floor that can sit above tol: stop
        # once the residual has stalled for `window` iterations
        self.window = 25 if torch.finfo(rel.dtype).bits <= 32 else 100
        self.rel = self.best = rel
        self.b_norm = b_norm
        self.since = torch.zeros((), dtype=torch.int32, device=rel.device)
        self.x_best = x
        self.select = select

    def running(self, tol: float) -> bool:
        """Residual above ``tol``, b nonzero and no stall: one counted host
        read (``core.sync``)."""
        return sync.read((self.rel > tol) & (self.b_norm > 0.0) & (self.since < self.window))

    def accept(self, pAp, rel_new, rz_new, new: tuple, old: tuple, rz):
        """Take the update ``new`` = (x, r, p) over ``old`` unless pAp <= 0
        or a value is non-finite: a rejected update keeps the last good
        iterate and trips the stagnation exit. Returns (x, r, p, rz)."""
        ok = (pAp > 0.0) & torch.isfinite(rel_new) & torch.isfinite(rz_new)
        x, r, p = (self.select(ok, a, c) for a, c in zip(new, old))
        rz = torch.where(ok, rz_new, rz)
        self.rel = torch.where(ok, rel_new, self.rel)
        improved = ok & (self.rel < self.best * 0.9999)
        self.best = torch.minimum(self.best, self.rel)
        self.since = torch.where(improved, torch.zeros_like(self.since),
                                 torch.where(ok, self.since + 1, torch.full_like(self.since, self.window)))
        self.x_best = self.select(self.rel <= self.best, x, self.x_best)
        return x, r, p, rz


def solve_pcg(op: StencilOp, b: torch.Tensor, tol: float, max_iter: int, singular: bool,
              precond: str = "mg", n_pre: int = 1, n_post: int = 1,
              x0: Optional[torch.Tensor] = None, levels=None, precond_dtype=None):
    """Solve A x = b from zero (or the warm start ``x0``).

    Returns (x, rel_residual, iterations): ``rel_residual`` a 0-d tensor,
    ``iterations`` an int. The warm start is guarded (discarded if
    ||b - A x0|| >= ||b||). The loop stops at ``tol``, at ``max_iter``, on a
    stagnation window (no 0.01% improvement for 25 iterations in f32, 100 in
    f64), or on a breakdown (non-positive pAp or a non-finite value), and
    returns the best iterate seen (:class:`Guards`). ``precond_dtype``: the V-cycle's storage dtype
    (see :func:`make_m_inv`).

    The JAX package reaches its fused init (``step_init``) only under its
    TPU band layout, which is not ported; here every solve starts with
    ``step_init``."""
    M_inv, _ = make_m_inv(op, precond, levels=levels, n_pre=n_pre, n_post=n_post,
                          precond_dtype=precond_dtype)

    def project(v):
        return v - torch.mean(v) if singular else v

    with profiling.annotate(SOLVE_RANGE):
        x, r, bb, rr, sum_r = cuda_cg.step_init(op, b, None if x0 is None else x0.to(b.dtype), singular)
        b_norm = torch.sqrt(bb)
        safe_b_norm = torch.where(b_norm > 0.0, b_norm, torch.ones_like(b_norm))
        _, p, rz = cuda_cg.step_c(r, M_inv(r), None, torch.ones_like(bb), singular, sum_r=sum_r)
        guards = Guards(torch.sqrt(rr) / safe_b_norm, b_norm, x)

        k = 0
        while k < max_iter and guards.running(tol):
            x_new, r_new, pAp, rr, sum_r = cuda_cg.step_ab(op, x, r, p, rz)
            _, p_new, rz_new = cuda_cg.step_c(r_new, M_inv(r_new), p, rz, singular, sum_r=sum_r)
            with profiling.annotate(GUARD_RANGE):
                x, r, p, rz = guards.accept(pAp, torch.sqrt(rr) / safe_b_norm, rz_new,
                                            (x_new, r_new, p_new), (x, r, p), rz)
            k += 1
        return project(guards.x_best), guards.best, k
