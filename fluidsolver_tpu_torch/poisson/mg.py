"""Geometric multigrid V-cycle for the 5-point pressure operator: port of
``fluidsolver_tpu.poisson.mg``, the analog of HYPRE's PFMG preconditioner.

  * coarsening: 2x2 cell aggregation with piecewise-constant transfers and
    the exact Galerkin (RAP) coarse operator, which for a 5-point fine
    operator is again 5-point, so every level is five coefficient planes;
  * smoother: red-black Gauss-Seidel, one sweep per launch of kernel 9
    (``cuda_smoother.rb_sweep``, the JAX package's ``mg._rb_sweep``) on
    every level, the coarsest included; post-smoothing sweeps black first,
    so that the V-cycle is a symmetric operator;
  * odd level sides are zero-padded before coarsening (dummy cells with
    aC = 0, guarded by the smoother) and the prolongation crops them.

The hierarchy's structure follows from the finest shape alone (sides halve,
rounding up, until the larger is at most COARSEST), so building it reads
nothing back to the host. The checkerboard is the parity of the level's
own indices. Residuals and transfers are plain PyTorch, as the JAX package
leaves them to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from fluidsolver_tpu_torch.poisson.cuda_smoother import rb_sweep
from fluidsolver_tpu_torch.poisson.linsys import StencilOp, apply_op

MAX_LEVELS = 16  # the reference's PFMG level cap
COARSEST = 4     # stop coarsening at <= 4 cells per side
COARSE_SWEEPS = 16


def _pad_even(a: torch.Tensor) -> torch.Tensor:
    px, py = a.shape[0] % 2, a.shape[1] % 2
    return F.pad(a, (0, py, 0, px)) if px or py else a


def _safe(d):
    return torch.where(d == 0.0, torch.ones_like(d), d)


def galerkin_coarsen(op: StencilOp) -> StencilOp:
    """Exact RAP with piecewise-constant transfers over 2x2 blocks.

    For block (I,J) = fine cells {2I,2I+1} x {2J,2J+1}:
      aC_c = sum(aC_f) + internal x couplings + internal y couplings
      aL_c = sum_j aL_f(2I, j),   aR_c = sum_j aR_f(2I+1, j)
      aB_c = sum_i aB_f(i, 2J),   aT_c = sum_i aT_f(i, 2J+1)
    """
    N, M = _pad_even(op.aC).shape

    def blocks(a):
        return _pad_even(a).reshape(N // 2, 2, M // 2, 2)

    bC, bL, bR, bB, bT = (blocks(a) for a in (op.aC, op.aL, op.aR, op.aB, op.aT))
    # internal couplings absorbed into the coarse diagonal
    internal_x = bR[:, 0, :, :].sum(-1) + bL[:, 1, :, :].sum(-1)
    internal_y = bT[:, :, :, 0].sum(1) + bB[:, :, :, 1].sum(1)
    return StencilOp(aC=bC.sum((1, 3)) + internal_x + internal_y,
                     aL=bL[:, 0, :, :].sum(-1), aR=bR[:, 1, :, :].sum(-1),
                     aB=bB[:, :, :, 0].sum(1), aT=bT[:, :, :, 1].sum(1))


def build_hierarchy(op: StencilOp) -> list:
    """The levels' operators, finest first."""
    levels = [op]
    while len(levels) < MAX_LEVELS and max(levels[-1].aC.shape) > COARSEST:
        levels.append(galerkin_coarsen(levels[-1]))
    return levels


def restrict_pc(r: torch.Tensor) -> torch.Tensor:
    """Piecewise-constant R = P^T: sum over 2x2 blocks (zero-padding odd
    edges)."""
    r = _pad_even(r)
    N, M = r.shape
    return r.reshape(N // 2, 2, M // 2, 2).sum((1, 3))


def prolong_pc(e: torch.Tensor, fine_shape) -> torch.Tensor:
    """Piecewise-constant injection, cropped back to the fine shape."""
    up = e.repeat_interleave(2, dim=0).repeat_interleave(2, dim=1)
    return up[: fine_shape[0], : fine_shape[1]]


# ---- bilinear transfers (an experiment of the JAX package's v_cycle) --------
# Cell-centred 2:1 bilinear interpolation: fine cell (2I+a, 2J+b) takes 9/16
# of coarse (I,J), 3/16 of each adjacent coarse cell toward its quadrant,
# 1/16 of the diagonal; edges clamp. The restriction is 4x the exact
# transpose, so the V-cycle stays symmetric with PC-Galerkin scaling.
_WC, _WE, _WD = 9.0 / 16.0, 3.0 / 16.0, 1.0 / 16.0


def _pad_edge(e):
    e = torch.cat([e[:1], e, e[-1:]], 0)
    return torch.cat([e[:, :1], e, e[:, -1:]], 1)


def prolong_bilinear(e: torch.Tensor, fine_shape) -> torch.Tensor:
    ep = _pad_edge(e)
    c = ep[1:-1, 1:-1]
    xm, xp = ep[:-2, 1:-1], ep[2:, 1:-1]
    ym, yp = ep[1:-1, :-2], ep[1:-1, 2:]
    q00 = _WC * c + _WE * (xm + ym) + _WD * ep[:-2, :-2]
    q10 = _WC * c + _WE * (xp + ym) + _WD * ep[2:, :-2]
    q01 = _WC * c + _WE * (xm + yp) + _WD * ep[:-2, 2:]
    q11 = _WC * c + _WE * (xp + yp) + _WD * ep[2:, 2:]
    I, J = e.shape
    row0 = torch.stack([q00, q01], dim=-1).reshape(I, 2 * J)
    row1 = torch.stack([q10, q11], dim=-1).reshape(I, 2 * J)
    fine = torch.stack([row0, row1], dim=1).reshape(2 * I, 2 * J)
    return fine[: fine_shape[0], : fine_shape[1]]


def _fold_mx(a):
    out = torch.zeros_like(a)
    out[:-1, :] += a[1:, :]
    out[0, :] += a[0, :]
    return out


def _fold_px(a):
    out = torch.zeros_like(a)
    out[1:, :] += a[:-1, :]
    out[-1, :] += a[-1, :]
    return out


def _fold_my(a):
    out = torch.zeros_like(a)
    out[:, :-1] += a[:, 1:]
    out[:, 0] += a[:, 0]
    return out


def _fold_py(a):
    out = torch.zeros_like(a)
    out[:, 1:] += a[:, :-1]
    out[:, -1] += a[:, -1]
    return out


def restrict_bilinear(r: torch.Tensor) -> torch.Tensor:
    """4 * P_bilinear^T (zero-extend odd fine edges, then de-interleave)."""
    r = _pad_even(r)
    R00, R10, R01, R11 = r[0::2, 0::2], r[1::2, 0::2], r[0::2, 1::2], r[1::2, 1::2]
    out = _WC * (R00 + R10 + R01 + R11)
    out = out + _WE * (_fold_mx(R00 + R01) + _fold_px(R10 + R11))
    out = out + _WE * (_fold_my(R00 + R10) + _fold_py(R01 + R11))
    out = out + _WD * (
        _fold_mx(_fold_my(R00)) + _fold_px(_fold_my(R10))
        + _fold_mx(_fold_py(R01)) + _fold_px(_fold_py(R11))
    )
    return 4.0 * out


# ---- operator-induced transfers (smoothed-aggregation form) -----------------
# P = (I - D^{-1} A) P_pc: each fine cell interpolates from the coarse blocks
# of its stencil neighbours, weighted by the face conductances; R = P^T.
def prolong_oi(op: StencilOp, e: torch.Tensor, fine_shape) -> torch.Tensor:
    ef = prolong_pc(e, fine_shape)
    return ef - apply_op(op, ef) / _safe(op.aC)


def restrict_oi(op: StencilOp, r: torch.Tensor) -> torch.Tensor:
    return restrict_pc(r - apply_op(op, r / _safe(op.aC)))


_TRANSFERS = {
    "pc": (lambda op, r: restrict_pc(r), lambda op, e, shape: prolong_pc(e, shape)),
    "bilinear": (lambda op, r: restrict_bilinear(r), lambda op, e, shape: prolong_bilinear(e, shape)),
    "oi": (restrict_oi, prolong_oi),
}


def v_cycle(levels: list, b: torch.Tensor, n_pre: int = 1, n_post: int = 1,
            transfers: str = "pc") -> torch.Tensor:
    """One V(n_pre, n_post) cycle from a zero initial guess: an
    approximation of A^{-1} b (the PCG preconditioner). ``transfers``: "pc"
    (the default and the solver's), "bilinear" or "oi" (the operator-induced
    form), the JAX package's measured experiments. The coarsest level runs
    COARSE_SWEEPS sweeps as forward/backward pairs."""
    if transfers not in _TRANSFERS:
        raise ValueError(f"unknown transfers: {transfers!r}")
    restrict, prolong = _TRANSFERS[transfers]

    def cycle(lvl: int, b_l: torch.Tensor) -> torch.Tensor:
        op = levels[lvl]
        x = torch.zeros_like(b_l)
        if lvl == len(levels) - 1:
            for _ in range(COARSE_SWEEPS // 2):
                x = rb_sweep(op, x, b_l)
                x = rb_sweep(op, x, b_l, reverse=True)
            return x
        for _ in range(n_pre):
            x = rb_sweep(op, x, b_l)
        ec = cycle(lvl + 1, restrict(op, b_l - apply_op(op, x)))
        x = x + prolong(op, ec, b_l.shape)
        for _ in range(n_post):
            x = rb_sweep(op, x, b_l, reverse=True)
        return x

    return cycle(0, b)
