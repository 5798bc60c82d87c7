"""Velocity boundary conditions on the ghost ring.

Port of ``fluidsolver_tpu.core.bc``: each side is applied in the order
left, right, bottom, top, every assignment seeing the ones before it. BC
values are numbers or callables ``f(coord, t) -> value`` that take torch
tensors (the coordinate along the side and the time as a 0-d tensor).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Union

import torch

from bench_port.reference.plain.core.grid import Grid

BCValue = Union[float, Callable]


@functools.lru_cache(maxsize=64)
def _coords(grid: Grid, name: str, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The grid's coordinate array ``name`` ("x", "xm", "y" or "ym") as a
    tensor, copied from the host once per grid, dtype and device (the
    last 64 kept). Callers share it and must not write to it."""
    return torch.as_tensor(getattr(grid, name), dtype=dtype, device=device)


def _eval(value: BCValue, grid: Grid, coords: str, t, like: torch.Tensor):
    """A constant or function-valued BC evaluated along one side. A constant
    is filled on the device (no host copy); a callable gets the side's
    coordinates ``grid.<coords>`` as a tensor of ``like``'s dtype and device
    (cached, so a step copies nothing from the host) and the time."""
    if callable(value):
        return value(_coords(grid, coords, like.dtype, like.device),
                     torch.as_tensor(t, dtype=like.dtype, device=like.device))
    return torch.full_like(like, value)


@dataclasses.dataclass(frozen=True)
class Dirichlet:
    """Fixed velocity on a wall; value or function of (tangential coord, t)."""

    u: BCValue = 0.0
    v: BCValue = 0.0


@dataclasses.dataclass(frozen=True)
class Neumann:
    """Zero-gradient; ``clipped`` prevents inflow at an outlet."""

    clipped: bool = False


@dataclasses.dataclass(frozen=True)
class Periodic:
    pass


@dataclasses.dataclass(frozen=True)
class Symmetry:
    pass


BCType = Union[Dirichlet, Neumann, Periodic, Symmetry]


@dataclasses.dataclass(frozen=True)
class FlowBCs:
    left: BCType
    right: BCType
    bottom: BCType
    top: BCType


def apply_velocity_bcs(U: torch.Tensor, V: torch.Tensor, grid: Grid, bcs: FlowBCs, t=-1.0):
    """Fill ghost/boundary-face values of the staggered velocity; returns
    new (U, V), the inputs are not modified."""
    nx, ny = grid.nx, grid.ny
    U = U.clone()
    V = V.clone()

    b = bcs.left
    if isinstance(b, Dirichlet):
        ubc = _eval(b.u, grid, "ym", t, U[0, :])
        vbc = _eval(b.v, grid, "y", t, V[0, :])
        U[0, :] = ubc
        U[1, :] = ubc
        V[0, :] = 2.0 * vbc - V[1, :]
    elif isinstance(b, Neumann):
        U[0, :] = U[1, :].clamp_max(0.0) if b.clipped else U[1, :]
        V[0, :] = V[1, :]
    elif isinstance(b, Periodic):
        U[0, :] = U[nx, :]
        V[0, :] = V[nx, :]
    elif isinstance(b, Symmetry):
        U[0, :] = -U[2, :]
        U[1, :] = 0.0
        V[0, :] = V[1, :]

    b = bcs.right
    if isinstance(b, Dirichlet):
        ubc = _eval(b.u, grid, "ym", t, U[0, :])
        vbc = _eval(b.v, grid, "y", t, V[0, :])
        U[nx + 1, :] = ubc
        U[nx + 2, :] = ubc
        V[nx + 1, :] = 2.0 * vbc - V[nx, :]
    elif isinstance(b, Neumann):
        U[nx + 2, :] = U[nx + 1, :].clamp_min(0.0) if b.clipped else U[nx + 1, :]
        V[nx + 1, :] = V[nx, :]
    elif isinstance(b, Periodic):
        U[nx + 2, :] = U[2, :]
        V[nx + 1, :] = V[1, :]
        if isinstance(bcs.left, Periodic):
            # logical faces 0 and nx are the same physical face: reconcile
            # the two images (see fluidsolver_tpu.core.bc)
            shared = 0.5 * (U[1, :] + U[nx + 1, :])
            U[1, :] = shared
            U[nx + 1, :] = shared
    elif isinstance(b, Symmetry):
        U[nx + 2, :] = -U[nx, :]
        U[nx + 1, :] = 0.0
        V[nx + 1, :] = V[nx, :]

    b = bcs.bottom
    if isinstance(b, Dirichlet):
        ubc = _eval(b.u, grid, "x", t, U[:, 0])
        vbc = _eval(b.v, grid, "xm", t, V[:, 0])
        U[:, 0] = 2.0 * ubc - U[:, 1]
        V[:, 0] = vbc
        V[:, 1] = vbc
    elif isinstance(b, Neumann):
        U[:, 0] = U[:, 1]
        V[:, 0] = V[:, 1].clamp_max(0.0) if b.clipped else V[:, 1]
    elif isinstance(b, Periodic):
        U[:, 0] = U[:, ny]
        V[:, 0] = V[:, ny]
    elif isinstance(b, Symmetry):
        U[:, 0] = U[:, 1]
        V[:, 0] = -V[:, 2]
        V[:, 1] = 0.0

    b = bcs.top
    if isinstance(b, Dirichlet):
        ubc = _eval(b.u, grid, "x", t, U[:, 0])
        vbc = _eval(b.v, grid, "xm", t, V[:, 0])
        U[:, ny + 1] = 2.0 * ubc - U[:, ny]
        V[:, ny + 1] = vbc
        V[:, ny + 2] = vbc
    elif isinstance(b, Neumann):
        U[:, ny + 1] = U[:, ny]
        V[:, ny + 2] = V[:, ny + 1].clamp_min(0.0) if b.clipped else V[:, ny + 1]
    elif isinstance(b, Periodic):
        U[:, ny + 1] = U[:, 1]
        V[:, ny + 2] = V[:, 2]
        if isinstance(bcs.bottom, Periodic):
            shared = 0.5 * (V[:, 1] + V[:, ny + 1])
            V[:, 1] = shared
            V[:, ny + 1] = shared
    elif isinstance(b, Symmetry):
        U[:, ny + 1] = U[:, ny]
        V[:, ny + 2] = -V[:, ny]
        V[:, ny + 1] = 0.0

    return U, V


def apply_neumann_scalar(f: torch.Tensor) -> torch.Tensor:
    """Copy of ``f`` with its ghost ring := nearest interior value, x-direction
    first then y (the corners take the y-fill of the x-filled rows)."""
    f = f.clone()
    f[0, :] = f[1, :]
    f[-1, :] = f[-2, :]
    f[:, 0] = f[:, 1]
    f[:, -1] = f[:, -2]
    return f


def apply_dirichlet_scalar(f: torch.Tensor, value: float) -> torch.Tensor:
    """Copy of ``f`` with its ghost ring := ``value``."""
    f = f.clone()
    f[0, :] = value
    f[-1, :] = value
    f[:, 0] = value
    f[:, -1] = value
    return f
