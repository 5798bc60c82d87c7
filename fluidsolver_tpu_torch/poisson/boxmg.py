"""BoxMG: operator-dependent blackbox multigrid (Dendy 1982, JCP 48).

Port of ``fluidsolver_tpu.poisson.boxmg``. Coarse unknowns are the
even-index subset of the cell-center graph, the interpolation collapses the
operator rows (``collapse_weights``), restriction is its exact transpose,
and the Galerkin product ``P^T A P`` is a 9-point stencil in closed form
(``galerkin_closed``). The functions here are the plain PyTorch algebra; the
kernels that run it on the GPU live in ``cuda_rap`` (one level's setup),
``cuda_vcycle`` (smoothing phases with fused transfers) and ``cuda_tail``
(the coarse tail's setup and cycle).

Hierarchy structure is decided by shape and dtype alone, the same on CPU
and GPU, and is the JAX package's: an f32 hierarchy starts the tail at the
first level whose remaining depth is in [2, MAX_TAIL_LEVELS] and whose
largest side is at most MAX_TAIL_SIDE (the tail's coarsest level runs
COARSE_SWEEPS symmetric sweeps in the kernel); the levels above it get
``fused_rap`` + ``fused_smooth``. The tail is f32 only, as in the JAX
package (whose tail gate refuses any other dtype); every other hierarchy,
and an f32 one whose tail does not fit, descends with ``fused_rap`` to the
JAX package's stop and, when its coarsest level is small enough
(``_direct``), solves it with the dense inverse (``_dense_coarse_inverse``,
one matrix-vector product a V-cycle). Only a coarsest level too large for
the inverse is swept COARSE_SWEEPS times, as the JAX package's is.

A low-precision hierarchy (``pressure_precond_dtype``, bf16) is the JAX
package's ``cast_hierarchy``: the levels are built at full precision with
``fused_rap`` all the way down, without the tail (whose kernels are f32 and
f64 only), their planes are cast once, and the coarsest level, when it is
small enough, is solved with an f32 dense inverse
(``_dense_coarse_inverse``). Its V-cycle runs ``fused_smooth`` on bf16
storage with f32 arithmetic on every level above the coarsest.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

import torch
import torch.nn.functional as F

from fluidsolver_tpu_torch.poisson.linsys import StencilOp, apply_op, shift
from fluidsolver_tpu_torch.utils import profiling

MAX_LEVELS = 16
COARSEST = 4
# symmetric sweep pairs x2 on the coarsest level
COARSE_SWEEPS = 32
# the JAX package's dense-inverse stop: a level this small is the coarsest;
# an f32 tail sweeps it, every other hierarchy inverts it densely
DIRECT_COARSEST = 16
DIRECT_CAP = 512
MAX_TAIL_LEVELS = 6
MAX_TAIL_SIDE = 160


@dataclasses.dataclass
class Stencil9:
    """9-point operator as coefficient arrays (5-point + corners)."""

    aC: torch.Tensor
    aL: torch.Tensor
    aR: torch.Tensor
    aB: torch.Tensor
    aT: torch.Tensor
    aSW: torch.Tensor
    aSE: torch.Tensor
    aNW: torch.Tensor
    aNE: torch.Tensor


@dataclasses.dataclass
class BoxTransfer:
    """Interpolation weights, all shaped (Nc, Mc) = coarse shape.

    Fine index convention (N = fine rows, Nc = (N+1)//2):
      fine (2k,   2l)   <- injection from coarse (k, l)
      fine (2k+1, 2l)   <- pW[k,l]*c(k,l)   + pE[k,l]*c(k+1,l)
      fine (2k,   2l+1) <- pS[k,l]*c(k,l)   + pN[k,l]*c(k,l+1)
      fine (2k+1, 2l+1) <- pSW[k,l]*c(k,l)  + pSE[k,l]*c(k+1,l)
                         + pNW[k,l]*c(k,l+1)+ pNE[k,l]*c(k+1,l+1)
    Rows beyond the fine grid carry zero weights.
    """

    pW: torch.Tensor
    pE: torch.Tensor
    pS: torch.Tensor
    pN: torch.Tensor
    pSW: torch.Tensor
    pSE: torch.Tensor
    pNW: torch.Tensor
    pNE: torch.Tensor


Operator = Union[StencilOp, Stencil9]
COEF_NAMES = ("aC", "aL", "aR", "aB", "aT", "aSW", "aSE", "aNW", "aNE")
WEIGHT_NAMES = ("pW", "pE", "pS", "pN", "pSW", "pSE", "pNW", "pNE")


def cast_struct(s, dtype):
    """A copy of an operator or transfer (any dataclass of planes) with
    every plane cast to ``dtype``; None stays None."""
    if s is None:
        return None
    return dataclasses.replace(s, **{f.name: getattr(s, f.name).to(dtype)
                                     for f in dataclasses.fields(s)})


def coefs(op: Operator) -> list:
    """The operator's coefficient planes in Stencil9 order (5 or 9)."""
    return [getattr(op, n) for n in COEF_NAMES[:9 if isinstance(op, Stencil9) else 5]]


def _corners(op):
    if isinstance(op, Stencil9):
        return op.aSW, op.aSE, op.aNW, op.aNE
    z = torch.zeros_like(op.aC)
    return z, z, z, z


def apply_op9(op: Stencil9, x: torch.Tensor) -> torch.Tensor:
    """y = A x for the 9-point stencil, zero beyond-edge neighbors."""
    return (
        op.aC * x
        + op.aL * shift(x, -1, 0) + op.aR * shift(x, 1, 0)
        + op.aB * shift(x, 0, -1) + op.aT * shift(x, 0, 1)
        + op.aSW * shift(x, -1, -1) + op.aSE * shift(x, 1, -1)
        + op.aNW * shift(x, -1, 1) + op.aNE * shift(x, 1, 1)
    )


def apply_any(op: Operator, x: torch.Tensor) -> torch.Tensor:
    return apply_op(op, x) if isinstance(op, StencilOp) else apply_op9(op, x)


def _safe(d):
    return torch.where(d == 0.0, torch.ones_like(d), d)


def _pad_to(a, shape):
    return F.pad(a, (0, shape[1] - a.shape[1], 0, shape[0] - a.shape[0]))


def stride2(a: torch.Tensor, i0: int = 0, j0: int = 0) -> torch.Tensor:
    """``a[i0::2, j0::2]`` (the JAX package's form of it only avoids TPU
    gathers)."""
    return a[i0::2, j0::2]


def collapse_weights(op: Operator) -> BoxTransfer:
    """Operator-collapsed interpolation weights (Dendy 1982 eqs. 3.2-3.5).

    Fine points on coarse lines collapse their row perpendicular to the
    line; (odd, odd) points collapse the full row using the line weights.
    For zero-row-sum operators every P row sums to 1; identity (pinned)
    rows get zero weights."""
    c, w, e, s, n = op.aC, op.aL, op.aR, op.aB, op.aT
    asw, ase, anw, ane = _corners(op)
    N, M = c.shape
    shape = ((N + 1) // 2, (M + 1) // 2)

    pW_full = -(w + anw + asw) / _safe(c + n + s)
    pE_full = -(e + ane + ase) / _safe(c + n + s)
    pS_full = -(s + asw + ase) / _safe(c + w + e)
    pN_full = -(n + anw + ane) / _safe(c + w + e)

    # one zero row/col at the high edge for the i+1 / j+1 reads
    pWf, pEf, pSf, pNf = (F.pad(a, (0, 1, 0, 1)) for a in (pW_full, pE_full, pS_full, pN_full))
    nk, nl = N // 2, M // 2

    def at(arr, di, dj):
        # arr at (odd i) + di, (odd j) + dj
        return arr[1 + di::2, 1 + dj::2][:nk, :nl]

    def oo(arr):
        return arr[1::2, 1::2][:nk, :nl]

    cden = _safe(oo(c))
    vSW = oo(asw) + oo(w) * at(pSf, -1, 0) + oo(s) * at(pWf, 0, -1)
    vSE = oo(ase) + oo(e) * at(pSf, +1, 0) + oo(s) * at(pEf, 0, -1)
    vNW = oo(anw) + oo(w) * at(pNf, -1, 0) + oo(n) * at(pWf, 0, +1)
    vNE = oo(ane) + oo(e) * at(pNf, +1, 0) + oo(n) * at(pEf, 0, +1)

    return BoxTransfer(
        pW=_pad_to(pW_full[1::2, 0::2], shape),
        pE=_pad_to(pE_full[1::2, 0::2], shape),
        pS=_pad_to(pS_full[0::2, 1::2], shape),
        pN=_pad_to(pN_full[0::2, 1::2], shape),
        pSW=_pad_to(-vSW / cden, shape),
        pSE=_pad_to(-vSE / cden, shape),
        pNW=_pad_to(-vNW / cden, shape),
        pNE=_pad_to(-vNE / cden, shape),
    )


def prolong_box(tr: BoxTransfer, e: torch.Tensor, fine_shape) -> torch.Tensor:
    """Fine = P e."""
    Nc, Mc = e.shape
    ep = F.pad(e, (0, 1, 0, 1))
    e10, e01, e11 = ep[1:, :Mc], ep[:Nc, 1:], ep[1:, 1:]
    fine = e.new_empty((2 * Nc, 2 * Mc))
    fine[0::2, 0::2] = e
    fine[1::2, 0::2] = tr.pW * e + tr.pE * e10
    fine[0::2, 1::2] = tr.pS * e + tr.pN * e01
    fine[1::2, 1::2] = tr.pSW * e + tr.pSE * e10 + tr.pNW * e01 + tr.pNE * e11
    return fine[: fine_shape[0], : fine_shape[1]]


def restrict_box(tr: BoxTransfer, r: torch.Tensor) -> torch.Tensor:
    """Coarse = P^T r (exact transpose of prolong_box, so the V-cycle stays
    a symmetric preconditioner)."""
    N, M = r.shape
    shape = ((N + 1) // 2, (M + 1) // 2)
    X = _pad_to(r[1::2, 0::2], shape)
    Y = _pad_to(r[0::2, 1::2], shape)
    T = _pad_to(r[1::2, 1::2], shape)

    def prev(a, di, dj):
        # a[k - di, l - dj], zero outside
        return F.pad(a[:a.shape[0] - di, :a.shape[1] - dj], (dj, 0, di, 0))

    out = r[0::2, 0::2]
    out = out + tr.pW * X + prev(tr.pE * X, 1, 0)
    out = out + tr.pS * Y + prev(tr.pN * Y, 0, 1)
    out = out + tr.pSW * T + prev(tr.pSE * T, 1, 0)
    out = out + prev(tr.pNW * T, 0, 1) + prev(tr.pNE * T, 1, 1)
    return out


def galerkin_boxmg(op: Operator, tr: BoxTransfer, fine_shape) -> Stencil9:
    """Galerkin coarse operator A_c = P^T A P by comb probing: the
    independent oracle of :func:`galerkin_closed` (never on the solve's
    path).

    A_c is 9-point, so coarse points whose indices agree mod 3 are never
    coupled: nine probes R(A(P(comb))) with period-3 combs recover every
    entry exactly."""
    Nc, Mc = tr.pW.shape
    dev = tr.pW.device
    I = torch.arange(Nc, device=dev)[:, None]
    J = torch.arange(Mc, device=dev)[None, :]
    Y = {}
    for a in range(3):
        for b in range(3):
            comb = (((I % 3) == a) & ((J % 3) == b)).to(tr.pW.dtype)
            Y[(a, b)] = restrict_box(tr, apply_any(op, prolong_box(tr, comb, fine_shape)))

    def coef(dI, dJ):
        # entry A_c((I, J) -> (I + dI, J + dJ)) lives in the comb of that class
        out = torch.zeros((Nc, Mc), dtype=tr.pW.dtype, device=dev)
        for (a, b), y in Y.items():
            mask = (((I + dI) % 3) == a) & (((J + dJ) % 3) == b)
            out = out + torch.where(mask, y, torch.zeros_like(y))
        valid = (I + dI >= 0) & (I + dI < Nc) & (J + dJ >= 0) & (J + dJ < Mc)
        return torch.where(valid, out, torch.zeros_like(out))

    return Stencil9(**{name: coef(*_A_OFFSETS[name]) for name in COEF_NAMES})


# ---- closed-form Galerkin product ------------------------------------------
# A_c = P^T A P enumerated symbolically: P has <= 4 entries per fine-parity
# class, A has 5 or 9 offsets, so every coarse coupling is a finite sum of
# triple products w1 * a * w2 sampled at affine positions in the coarse
# index. The CUDA kernels (csrc/boxmg_device.cuh) enumerate the same terms
# in the same order.

# P entries per fine parity (a, b): (sI, sJ, weight_name)
#   fine (2k+a, 2l+b) <- coarse (k+sI, l+sJ) with weight W[k, l]
_P_ENTRIES = {
    (0, 0): [(0, 0, "one")],
    (1, 0): [(0, 0, "pW"), (1, 0, "pE")],
    (0, 1): [(0, 0, "pS"), (0, 1, "pN")],
    (1, 1): [(0, 0, "pSW"), (1, 0, "pSE"), (0, 1, "pNW"), (1, 1, "pNE")],
}
_A_OFFSETS = {
    "aC": (0, 0), "aL": (-1, 0), "aR": (1, 0), "aB": (0, -1), "aT": (0, 1),
    "aSW": (-1, -1), "aSE": (1, -1), "aNW": (-1, 1), "aNE": (1, 1),
}


def _enumerate_rap_terms(ncoef):
    """Terms for A_c[(K,L) -> (K+DK, L+DL)], keyed by (DK, DL): tuples
    (w1_name, g1, d1, a_name, alpha, beta, w2_name, g2, d2) where weights
    are sampled at coarse (K+g, L+d) and the operator at fine
    (2K+alpha, 2L+beta)."""
    names = list(_A_OFFSETS)[:ncoef]
    out = {}
    for (a1, b1), entries1 in _P_ENTRIES.items():
        for s1I, s1J, w1 in entries1:
            for a_name in names:
                di, dj = _A_OFFSETS[a_name]
                a2, b2 = (a1 + di) % 2, (b1 + dj) % 2
                for s2I, s2J, w2 in _P_ENTRIES[(a2, b2)]:
                    g1, d1 = -s1I, -s1J
                    alpha, beta = a1 - 2 * s1I, b1 - 2 * s1J
                    g2 = -s1I + (a1 + di - a2) // 2
                    d2 = -s1J + (b1 + dj - b2) // 2
                    DK, DL = g2 + s2I, d2 + s2J
                    out.setdefault((DK, DL), []).append(
                        (w1, g1, d1, a_name, alpha, beta, w2, g2, d2)
                    )
    return out


def galerkin_closed(op: Operator, tr: BoxTransfer, fine_shape) -> Stencil9:
    """Closed-form A_c = P^T A P."""
    N, M = fine_shape
    Nc, Mc = (N + 1) // 2, (M + 1) // 2
    ncoef = 9 if isinstance(op, Stencil9) else 5
    fine_pad = {name: F.pad(getattr(op, name), (2, 2, 2, 2)) for name in list(_A_OFFSETS)[:ncoef]}
    coarse_pad = {name: F.pad(getattr(tr, name), (1, 1, 1, 1)) for name in WEIGHT_NAMES}

    def fine_at(name, alpha, beta):
        return fine_pad[name][2 + alpha::2, 2 + beta::2][:Nc, :Mc]

    def coarse_at(name, g, d):
        return coarse_pad[name][1 + g:1 + g + Nc, 1 + d:1 + d + Mc]

    I = torch.arange(Nc, device=op.aC.device)[:, None]
    J = torch.arange(Mc, device=op.aC.device)[None, :]
    out = {}
    for (DK, DL), terms in _enumerate_rap_terms(ncoef).items():
        acc = torch.zeros((Nc, Mc), dtype=op.aC.dtype, device=op.aC.device)
        for (w1, g1, d1, a_name, alpha, beta, w2, g2, d2) in terms:
            v = fine_at(a_name, alpha, beta)
            if w1 != "one":
                v = v * coarse_at(w1, g1, d1)
            if w2 != "one":
                v = v * coarse_at(w2, g2, d2)
            acc = acc + v
        valid = (I + DK >= 0) & (I + DK < Nc) & (J + DL >= 0) & (J + DL < Mc)
        out[(DK, DL)] = torch.where(valid, acc, torch.zeros_like(acc))
    return Stencil9(**{name: out[_A_OFFSETS[name]] for name in COEF_NAMES})


# ---- smoothing -------------------------------------------------------------
def red_mask(shape, device) -> torch.Tensor:
    """Checkerboard: True where (i + j) is even."""
    i = torch.arange(shape[0], device=device)[:, None]
    j = torch.arange(shape[1], device=device)[None, :]
    return (i + j) % 2 == 0


def color_update(op: Operator, x, b, red: bool):
    """One red-black half-step: every point of the colour is replaced by its
    Gauss-Seidel value computed from the PREVIOUS iterate at all neighbours
    (also the same-colour 9-point corners), so a half-step is a pure
    function of x."""
    ax_off = apply_any(op, x) - op.aC * x
    x_new = (b - ax_off) / _safe(op.aC)
    mask = red_mask(x.shape, x.device)
    return torch.where(mask if red else ~mask, x_new, x)


def _rb_sweep(op: Operator, x, b, reverse: bool = False):
    """Red-black sweep (black first when ``reverse``)."""
    x = color_update(op, x, b, not reverse)
    return color_update(op, x, b, reverse)


# ---- hierarchy -------------------------------------------------------------
def _direct(shape) -> bool:
    """A level of ``shape`` is small enough for the dense coarse inverse."""
    return min(shape) <= DIRECT_COARSEST and shape[0] * shape[1] <= DIRECT_CAP


def _stop_here(shape, n_levels_incl: int) -> bool:
    """Whether a level of ``shape`` is the coarsest when the hierarchy holds
    ``n_levels_incl`` levels counting this one (the JAX package's stop
    predicate: MAX_LEVELS, the min-dimension floor, or small enough for a
    direct solve)."""
    return n_levels_incl >= MAX_LEVELS or min(shape) <= COARSEST or _direct(shape)


def _remaining_depth(shape, built: int) -> int:
    """How many levels the hierarchy would still hold from ``shape`` after
    ``built`` existing levels."""
    n, m, d = shape[0], shape[1], 0
    while True:
        d += 1
        if _stop_here((n, m), built + d):
            return d
        n, m = (n + 1) // 2, (m + 1) // 2


def tail_fits(shape, n_levels: int) -> bool:
    """A tail of ``n_levels`` levels may start at a level of ``shape``."""
    return 2 <= n_levels <= MAX_TAIL_LEVELS and max(shape) <= MAX_TAIL_SIDE


@dataclasses.dataclass
class BoxLevel:
    op: Operator
    tr: Optional[BoxTransfer] = None   # transfer to the next coarser level
    tail: object = None                # cuda_tail.TailPack from this level down
    coarse_inv: Optional[torch.Tensor] = None  # dense inverse of the coarsest level


def build_hierarchy(op: StencilOp, tail: bool = True) -> list:
    """Finest level keeps the 5-point operator; coarse levels are 9-point.
    Levels above the tail are built by ``fused_rap``; an f32 tail (all
    levels from its start down) by one ``build_tail_pack`` launch. Without
    a tail (another dtype, a tail that does not fit, or ``tail=False``: the
    full-precision build of :func:`cast_hierarchy`) every level is built
    with ``fused_rap`` down to the coarsest, which gets the dense inverse
    when it is small enough (the JAX package's ``build_hierarchy``)."""
    from fluidsolver_tpu_torch.poisson import cuda_rap, cuda_tail

    tail = tail and op.aC.dtype == torch.float32
    levels = []
    cur = op
    while True:
        shape = tuple(cur.aC.shape)
        n_rem = _remaining_depth(shape, len(levels))
        if tail and tail_fits(shape, n_rem):
            levels.append(BoxLevel(op=cur, tail=cuda_tail.build_tail_pack(cur, n_rem)))
            return levels
        if n_rem == 1:
            levels.append(BoxLevel(op=cur, coarse_inv=_dense_coarse_inverse(cur) if _direct(shape) else None))
            return levels
        tr, cur_next = cuda_rap.fused_rap(cur)
        levels.append(BoxLevel(op=cur, tr=tr))
        cur = cur_next


def _dense_coarse_inverse(op: Operator) -> torch.Tensor:
    """Dense symmetric inverse of a small coarsest-level operator, in f32 at
    least (the JAX package's ``_dense_coarse_inverse``).

    The stencil is materialised as an (n, n) matrix; all-zero rows become
    identity rows; the constant nullspace of an all-Neumann operator is
    deflated with the rank-one shift ``c / n_live * v v^T`` over the live
    rows (v = live indicator, c = mean |diagonal|). The shift is applied
    only when the operator really is singular (its live row sums vanish to
    within sqrt(eps) c), decided on the device with ``torch.where``; a
    pinned operator is inverted as it is. ``torch.linalg.inv_ex`` reads no
    error flag back to the host."""
    c = op.aC
    N, M = c.shape
    n = N * M
    dtype = torch.promote_types(c.dtype, torch.float32)
    I = torch.arange(N, device=c.device)[:, None].expand(N, M)
    J = torch.arange(M, device=c.device)[None, :].expand(N, M)
    rows = (I * M + J).reshape(-1)
    A = torch.zeros((n, n), dtype=dtype, device=c.device)
    for name in COEF_NAMES[:len(coefs(op))]:
        di, dj = _A_OFFSETS[name]
        valid = (I + di >= 0) & (I + di < N) & (J + dj >= 0) & (J + dj < M)
        cols = ((I + di) * M + (J + dj)).clamp(0, n - 1).reshape(-1)
        coef = getattr(op, name)
        vals = torch.where(valid, coef, torch.zeros_like(coef)).to(dtype).reshape(-1)
        A.index_put_((rows, cols), vals, accumulate=True)
    diag = torch.diagonal(A)
    live = diag != 0.0
    A = A + torch.diag((~live).to(dtype))
    v = live.to(dtype)
    n_live = torch.clamp(torch.sum(v), min=1.0)
    shift = torch.sum(torch.abs(diag)) / n_live
    # deflate only a genuinely singular (all-Neumann) operator
    rowsum_defect = torch.max(torch.abs(torch.where(live, A @ v, torch.zeros_like(v))))
    singularish = rowsum_defect < math.sqrt(torch.finfo(dtype).eps) * shift
    A = A + torch.where(singularish, shift / n_live, torch.zeros_like(shift)) * torch.outer(v, v)
    inv, _ = torch.linalg.inv_ex(A)
    return 0.5 * (inv + inv.T)


def cast_hierarchy(levels: list, dtype) -> list:
    """The hierarchy ``levels`` (built with ``tail=False``: the tail's
    kernels take f32 and f64 only) with every plane cast to ``dtype``
    (bf16: half the V-cycle's bytes), built at full precision and rounded
    once (the JAX package's ``cast_hierarchy``); the coarsest level keeps
    the dense inverse of its full-precision operator (f32 at least)."""
    if levels[-1].tail is not None:
        raise ValueError("cast a hierarchy built without the tail (build_hierarchy(op, tail=False))")
    return [BoxLevel(op=cast_struct(l.op, dtype), tr=cast_struct(l.tr, dtype), coarse_inv=l.coarse_inv)
            for l in levels]


# the profiler ranges of the V-cycle's smoothing phases (one ``fused_smooth``
# launch each), suffixed with the level's shape: ``pcg.smooth.restrict.NxM``
SMOOTH_RESTRICT = "pcg.smooth.restrict"
SMOOTH_CORRECT = "pcg.smooth.correct"
SMOOTH_COARSE = "pcg.smooth.coarse"


def v_cycle(levels: list, b: torch.Tensor, n_pre: int = 1, n_post: int = 1) -> torch.Tensor:
    """One symmetric V(n_pre, n_post) cycle from a zero initial guess. Each
    smoothing phase runs inside the profiler range of its form and level
    shape (``SMOOTH_RESTRICT``, ``SMOOTH_CORRECT``, ``SMOOTH_COARSE``)."""
    from fluidsolver_tpu_torch.poisson import cuda_tail, cuda_vcycle

    def cycle(lvl, b_l):
        level = levels[lvl]
        if level.tail is not None:
            return cuda_tail.tail_cycle(level.tail, b_l, n_pre, n_post)
        if level.coarse_inv is not None:
            # exact coarse solve: one product with the f32 inverse
            inv = level.coarse_inv
            return (inv @ b_l.reshape(-1).to(inv.dtype)).reshape(b_l.shape).to(b_l.dtype)
        if level.tr is None:
            # coarsest level without a tail: symmetric sweep pairs
            x = None
            for _ in range(COARSE_SWEEPS // 2):
                with profiling.annotate(SMOOTH_COARSE, *b_l.shape):
                    x = cuda_vcycle.fused_smooth(level.op, b_l, x0=x, colors=(True, False, False, True))
            return x
        with profiling.annotate(SMOOTH_RESTRICT, *b_l.shape):
            x, bc = cuda_vcycle.fused_smooth(level.op, b_l, colors=(True, False) * n_pre,
                                             tr=level.tr, restrict=True)
        ec = cycle(lvl + 1, bc)
        with profiling.annotate(SMOOTH_CORRECT, *b_l.shape):
            return cuda_vcycle.fused_smooth(level.op, b_l, x0=x, colors=(False, True) * n_post,
                                            tr=level.tr, ec=ec)

    return cycle(0, b)
