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

The work of an iteration outside the preconditioner is grouped as the
port's kernels 5-7 group it: ``step_init`` and ``step_c``'s init form
before the loop, ``step_ab`` and ``step_c`` in it, as the JAX package's
fused branch (``FS_PALLAS_CG``) has them; here each is the plain PyTorch
algebra (e.g. the projected dot rz_new = <r, z_raw> - mean(z_raw) sum_r, the
mean as sum * (1 / n)), reduced with ``torch.sum``.
"""

from __future__ import annotations

from contextlib import nullcontext
from typing import Optional

import torch
from torch.profiler import record_function

from bench_port.reference.plain.core import sync
from bench_port.reference.plain import _dtypes
from bench_port.reference.plain.poisson import boxmg
from bench_port.reference.plain.poisson.linsys import StencilOp, apply_op

_MG = {"boxmg": boxmg}
# the profiler range of an iteration's guard selects and bookkeeping, opened
# only while a profiler records (a range costs about as much host time as a
# tensor operation)
GUARD_RANGE = "pcg.guards"


def _safe(d):
    return torch.where(d != 0.0, d, torch.ones_like(d))


def step_ab(op: StencilOp, x, r, p, rz):
    """The alpha half of a PCG iteration: (x', r', pAp, rr, sum_r) with
    Ap = A p, pAp = <p, Ap>, alpha = rz / pAp (rz / 1 where pAp = 0),
    x' = x + alpha p, r' = r - alpha Ap, rr = <r', r'>, sum_r = sum(r')."""
    Ap = apply_op(op, p)
    pAp = torch.sum(p * Ap)
    alpha = rz / _safe(pAp)
    x_new = x + alpha * p
    r_new = r - alpha * Ap
    return x_new, r_new, pAp, torch.sum(r_new * r_new), torch.sum(r_new)


def step_c(r, z_raw, p, rz_prev, singular: bool, sum_r=None):
    """The beta half of a PCG iteration: (z, p', rz_new) with z = z_raw -
    mean(z_raw) if ``singular`` (else z_raw), rz_new = <r, z> (formed as
    <r, z_raw> - mean(z_raw) sum_r; ``sum_r`` = sum(r), from ``step_ab`` or
    ``step_init``, is needed only if ``singular``), p' = z + (rz_new /
    rz_prev) p. ``p=None`` is the solve-init form (p = 0): p' is z, the same
    tensor."""
    if singular and sum_r is None:
        raise ValueError("step_c: a singular system needs sum_r = sum(r)")
    rz_raw = torch.sum(r * z_raw)
    if singular:
        mean = torch.sum(z_raw) * (1.0 / z_raw.numel())
        z = z_raw - mean
        rz_new = rz_raw - mean * sum_r
    else:
        z, rz_new = z_raw, rz_raw
    if p is None:
        return z, z, rz_new
    beta = rz_new / _safe(rz_prev)
    return z, z + beta * p, rz_new


def step_init(op: StencilOp, b, x0: Optional[torch.Tensor], singular: bool):
    """The PCG init before the first preconditioner call: (x0', r0', bb,
    rr0, sum_r0). With ``singular`` b and x0 are projected (b1 = b -
    mean(b), x1 = x0 - mean(x0)); bb = <b1, b1>. A warm start ``x0`` is
    kept iff <r_ws, r_ws> < bb for r_ws = b1 - A x1: then (x0', r0') =
    (x1, r_ws), else (0, b1), as with a cold start (``x0=None``). rr0 and
    sum_r0 are <r0', r0'> and sum(r0')."""
    inv_n = 1.0 / b.numel()
    b1 = b - torch.sum(b) * inv_n if singular else b
    bb = torch.sum(b1 * b1)
    sum_b1 = torch.sum(b1)
    if x0 is None:
        return torch.zeros_like(b), b1, bb, bb, sum_b1
    x1 = x0 - torch.sum(x0) * inv_n if singular else x0
    r_ws = b1 - apply_op(op, x1)
    rr_ws = torch.sum(r_ws * r_ws)
    good = rr_ws < bb
    return (torch.where(good, x1, torch.zeros_like(b)), torch.where(good, r_ws, b1), bb,
            torch.where(good, rr_ws, bb), torch.where(good, torch.sum(r_ws), sum_b1))


def build_precond_levels(op: StencilOp, precond: str, precond_dtype=None):
    """The multigrid hierarchy for ``precond`` "mg" or "boxmg"; None for
    the others. Solvers build it once and reuse it over several solves.
    ``precond_dtype`` (a torch dtype or its name): the hierarchy's storage
    dtype, if it differs from the operator's."""
    if precond not in _MG:
        return None
    if precond_dtype is not None:
        precond_dtype = _dtypes.torch_dtype(precond_dtype)
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
    solve makes it in :func:`step_init`."""

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

    x, r, bb, rr, sum_r = step_init(op, b, None if x0 is None else x0.to(b.dtype), singular)
    b_norm = torch.sqrt(bb)
    safe_b_norm = torch.where(b_norm > 0.0, b_norm, torch.ones_like(b_norm))
    _, p, rz = step_c(r, M_inv(r), None, torch.ones_like(bb), singular, sum_r=sum_r)
    guards = Guards(torch.sqrt(rr) / safe_b_norm, b_norm, x)

    k = 0
    while k < max_iter and guards.running(tol):
        x_new, r_new, pAp, rr, sum_r = step_ab(op, x, r, p, rz)
        _, p_new, rz_new = step_c(r_new, M_inv(r_new), p, rz, singular, sum_r=sum_r)
        with record_function(GUARD_RANGE) if torch.autograd._profiler_enabled() else nullcontext():
            x, r, p, rz = guards.accept(pAp, torch.sqrt(rr) / safe_b_norm, rz_new, (x_new, r_new, p_new),
                                        (x, r, p), rz)
        k += 1
    return project(guards.x_best), guards.best, k
