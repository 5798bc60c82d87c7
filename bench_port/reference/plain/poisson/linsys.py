"""Variable-coefficient pressure-Poisson system: port of
``fluidsolver_tpu.poisson.linsys``.

The 5-point operator ``-vol * div((1/rho_face) grad)`` is assembled over
the full ghost-inclusive box (all (nx+2) x (ny+2) cells are unknowns) with
one-sided closure at the box edges (homogeneous Neumann), an optional
Dirichlet-pinned edge, and mean subtraction of the RHS in the all-Neumann
(singular) case. It is kept matrix-free as five coefficient arrays.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

PIN_NONE = None
PIN_LEFT = "left"
PIN_RIGHT = "right"
PIN_BOTTOM = "bottom"
PIN_TOP = "top"


@dataclasses.dataclass
class StencilOp:
    """5-point operator as coefficient arrays over the box."""

    aC: torch.Tensor
    aL: torch.Tensor
    aR: torch.Tensor
    aB: torch.Tensor
    aT: torch.Tensor


def assemble_pressure_operator(rho_u, rho_v, dx: float, dy: float,
                               pin: Optional[str] = PIN_NONE) -> StencilOp:
    """Build the operator from the staggered face densities. ``rho_u``:
    (nx+3, ny+2), ``rho_v``: (nx+2, ny+3); box unknowns: (nx+2, ny+2)."""
    vol = dx * dy
    cx = vol / (dx * dx)
    cy = vol / (dy * dy)

    # face conductances; the outward coupling at the box edges (and its
    # diagonal contribution) is dropped: one-sided closure
    edgeL = cx / rho_u[:-1, :]
    edgeR = cx / rho_u[1:, :]
    edgeB = cy / rho_v[:, :-1]
    edgeT = cy / rho_v[:, 1:]
    edgeL[0, :] = 0.0
    edgeR[-1, :] = 0.0
    edgeB[:, 0] = 0.0
    edgeT[:, -1] = 0.0

    aC = edgeL + edgeR + edgeB + edgeT
    aL, aR, aB, aT = -edgeL, -edgeR, -edgeB, -edgeT

    if pin is not None:
        # pinned edge: identity rows with zero RHS; the couplings into the
        # pinned cells are eliminated too, so the operator stays symmetric
        if pin == PIN_LEFT:
            edge, inner, into = (0, slice(None)), (1, slice(None)), aL
        elif pin == PIN_RIGHT:
            edge, inner, into = (-1, slice(None)), (-2, slice(None)), aR
        elif pin == PIN_BOTTOM:
            edge, inner, into = (slice(None), 0), (slice(None), 1), aB
        elif pin == PIN_TOP:
            edge, inner, into = (slice(None), -1), (slice(None), -2), aT
        else:
            raise ValueError(f"unknown pin side: {pin}")
        aC[edge] = 1.0
        for a in (aL, aR, aB, aT):
            a[edge] = 0.0
        into[inner] = 0.0

    return StencilOp(aC=aC, aL=aL, aR=aR, aB=aB, aT=aT)


def build_pressure_rhs(div, dx: float, dy: float, dt, pin: Optional[str] = PIN_NONE,
                       periodic_x: bool = False, periodic_y: bool = False) -> torch.Tensor:
    """rhs = -vol * div / dt over the box; pinned edge zeroed, or (singular
    case) the mean subtracted. On a periodic axis the ghost entries are
    zeroed before and after the mean subtraction: they are wrap copies
    whose mean would otherwise leak into a uniform divergence offset."""
    vol = dx * dy
    rhs = -vol * div / dt
    if pin == PIN_LEFT:
        rhs[0, :] = 0.0
    elif pin == PIN_RIGHT:
        rhs[-1, :] = 0.0
    elif pin == PIN_BOTTOM:
        rhs[:, 0] = 0.0
    elif pin == PIN_TOP:
        rhs[:, -1] = 0.0
    elif pin is PIN_NONE:
        def zero_periodic_ghosts(r):
            if periodic_x:
                r[0, :] = 0.0
                r[-1, :] = 0.0
            if periodic_y:
                r[:, 0] = 0.0
                r[:, -1] = 0.0

        zero_periodic_ghosts(rhs)
        nx2, ny2 = rhs.shape
        n_support = (nx2 - 2 * periodic_x) * (ny2 - 2 * periodic_y)
        rhs = rhs - torch.sum(rhs) / n_support
        zero_periodic_ghosts(rhs)
    else:
        raise ValueError(f"unknown pin side: {pin}")
    return rhs


def shift(x: torch.Tensor, di: int, dj: int) -> torch.Tensor:
    """x[i+di, j+dj], zero outside the array (di, dj in {-1, 0, 1})."""
    n, m = x.shape
    x = x[max(di, 0):n + min(di, 0), max(dj, 0):m + min(dj, 0)]
    return F.pad(x, (max(-dj, 0), max(dj, 0), max(-di, 0), max(di, 0)))


def apply_op(op: StencilOp, x: torch.Tensor) -> torch.Tensor:
    """Matrix-free y = A x with zero-flux box edges."""
    return (op.aC * x + op.aL * shift(x, -1, 0) + op.aR * shift(x, 1, 0)
            + op.aB * shift(x, 0, -1) + op.aT * shift(x, 0, 1))
