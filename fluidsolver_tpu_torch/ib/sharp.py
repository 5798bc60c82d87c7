"""Sharp (ghost-cell) immersed boundary: port of ``fluidsolver_tpu.ib.sharp``.

Reference: examples/SharpIB.cpp:148-271, 428-462. Solid nodes next to fluid
get a velocity extrapolated along the dominant wall normal from the wall
distance ``beta``, with weights that give zero wall velocity; deep-solid
nodes are zeroed; the forcing comes after the outflow correction, before
the projection.

The classification, the direction, beta and the weights are made on the
host at set-up (the native sweep of ``csrc/ib_kernels.cpp`` for a circle,
the Python loop for any other shape) into flat int64 index tensors and
weights on the state's device; a step applies them as two gathers and two
scatters.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.ib import _native
from fluidsolver_tpu_torch.ib.geometry import Circle


@dataclasses.dataclass(frozen=True)
class FunctionShape:
    """A solid given by an indicator (> 0 inside) and an outward (solid to
    fluid) normal function; wall intersections by bisection."""

    indicator: Callable
    normal: Callable

    def contains(self, x, y):
        return np.asarray(self.indicator(x, y)) > 0.0

    def intersect_line(self, p_in, p_out, iters: int = 80):
        a = np.asarray(p_in, float)
        b = np.asarray(p_out, float)
        fa = float(self.indicator(a[0], a[1]))
        for _ in range(iters):
            m = 0.5 * (a + b)
            fm = float(self.indicator(m[0], m[1]))
            if (fm > 0.0) == (fa > 0.0):
                a = m
            else:
                b = m
        return tuple(0.5 * (a + b))


def _weights(beta: float, scheme: str):
    """Extrapolation weights of (U_wall = 0, U1, U2) (SharpIB.cpp:172-198)."""
    if scheme == "linear":
        return (1.0 / (1.0 - beta), -beta / (1.0 - beta), 0.0)
    beta1 = 0.5
    if beta < beta1:
        return (
            2.0 / ((1.0 - beta) * (2.0 - beta)),
            -2.0 * beta / (1.0 - beta),
            beta / (2.0 - beta),
        )
    w0 = 2.0 / ((1.0 - beta1) * (2.0 - beta1))
    return (w0, 2.0 - (2.0 - beta) * w0, -1.0 + (1.0 - beta) * w0)


@dataclasses.dataclass
class SharpStencil:
    tgt: torch.Tensor     # flat indices of the boundary solid nodes
    nb1: torch.Tensor     # flat indices of their first fluid neighbour
    nb2: torch.Tensor     # ... and of the second
    w1: torch.Tensor
    w2: torch.Tensor
    deep: torch.Tensor    # flat indices of the deep-solid interior nodes


@dataclasses.dataclass
class SharpIB:
    u: SharpStencil
    v: SharpStencil


def _build_stencil(shape, xs, ys, dx: float, dy: float, scheme: str) -> tuple:
    """The stencil of one staggered mesh as numpy arrays (tgt, nb1, nb2,
    w1, w2, deep), by a Python loop over the nodes."""
    nx, ny = len(xs), len(ys)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    solid = np.asarray(shape.contains(X, Y), bool)
    tgt, nb1, nb2, w1s, w2s, deep = [], [], [], [], [], []

    def flat(i, j):
        return i * ny + j

    for i in range(1, nx - 1):
        for j in range(1, ny - 1):
            if not solid[i, j]:
                continue
            fluid_nb = ((not solid[i + 1, j]) or (not solid[i - 1, j])
                        or (not solid[i, j + 1]) or (not solid[i, j - 1]))
            if not fluid_nb:
                deep.append(flat(i, j))
                continue
            nx_, ny_ = shape.normal(xs[i], ys[j])
            if abs(nx_) > abs(ny_):
                di, dj, h = (1, 0, dx) if nx_ > 0 else (-1, 0, dx)
            else:
                di, dj, h = (0, 1, dy) if ny_ > 0 else (0, -1, dy)
            p = (xs[i], ys[j])
            q = (xs[i + di], ys[j + dj])
            ix, iy = shape.intersect_line(p, q)
            beta = (abs(ix - p[0]) if dj == 0 else abs(iy - p[1])) / h
            _, w1, w2 = _weights(beta, scheme)
            tgt.append(flat(i, j))
            nb1.append(flat(i + di, j + dj))
            nb2.append(flat(min(max(i + 2 * di, 0), nx - 1), min(max(j + 2 * dj, 0), ny - 1)))
            w1s.append(w1)
            w2s.append(w2)
    ints = [np.asarray(a, np.int64) for a in (tgt, nb1, nb2)]
    return (*ints, np.asarray(w1s, np.float64), np.asarray(w2s, np.float64), np.asarray(deep, np.int64))


def _stencil_arrays(shape, xs, ys, dx: float, dy: float, scheme: str) -> tuple:
    """A circle's stencil from the native sweep, any other shape's from the
    Python loop."""
    if isinstance(shape, Circle):
        return _native.sharp_stencil_circle(xs, ys, dx, dy, shape.x, shape.y, shape.r, scheme)
    return _build_stencil(shape, xs, ys, dx, dy, scheme)


def _to_device(arrays, dtype: torch.dtype, device) -> SharpStencil:
    tgt, nb1, nb2, w1, w2, deep = arrays

    def idx(a):
        return torch.as_tensor(a, dtype=torch.int64, device=device)

    def val(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return SharpStencil(tgt=idx(tgt), nb1=idx(nb1), nb2=idx(nb2), w1=val(w1), w2=val(w2),
                        deep=idx(deep))


def build(shape, grid: Grid, dtype: torch.dtype, device, scheme: str = "linear") -> SharpIB:
    """The U and V stencils of ``shape`` on ``grid``, on ``device``."""
    return SharpIB(
        u=_to_device(_stencil_arrays(shape, grid.x, grid.ym, grid.dx, grid.dy, scheme), dtype, device),
        v=_to_device(_stencil_arrays(shape, grid.xm, grid.y, grid.dx, grid.dy, scheme), dtype, device),
    )


def _apply_one(field, st: SharpStencil):
    flat = field.reshape(-1)
    target = st.w1 * flat[st.nb1] + st.w2 * flat[st.nb2]
    out = flat.clone()
    out[st.deep] = 0.0
    out[st.tgt] = target
    return out.reshape(field.shape)


def apply_forcing(U, V, ib: SharpIB):
    """Set the solid nodes' velocities: extrapolated on the boundary ring,
    zero deep inside (SharpIB.cpp:428-462)."""
    return _apply_one(U, ib.u), _apply_one(V, ib.v)
