"""Field constructors and ghost-ring helpers.

The JAX package writes interior and edge updates as iota+where / pad+add
forms so that GSPMD partitions them; on one GPU plain slice assignment on
a fresh tensor computes the same values.
"""

from __future__ import annotations

import torch

from bench_port.reference.plain.core.grid import Grid


def zeros_center(grid: Grid, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(grid.shape_center, dtype=dtype, device=device)


def zeros_u(grid: Grid, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(grid.shape_u, dtype=dtype, device=device)


def zeros_v(grid: Grid, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.zeros(grid.shape_v, dtype=dtype, device=device)


def full_center(grid: Grid, value: float, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.full(grid.shape_center, value, dtype=dtype, device=device)


def full_u(grid: Grid, value: float, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.full(grid.shape_u, value, dtype=dtype, device=device)


def full_v(grid: Grid, value: float, dtype: torch.dtype, device) -> torch.Tensor:
    return torch.full(grid.shape_v, value, dtype=dtype, device=device)


def interior(f: torch.Tensor) -> torch.Tensor:
    """View of the interior (ghost ring stripped)."""
    return f[1:-1, 1:-1]


def set_interior(f: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Copy of ``f`` with its interior replaced (ghost ring kept)."""
    out = f.clone()
    out[1:-1, 1:-1] = values
    return out


def pad_interior(values: torch.Tensor) -> torch.Tensor:
    """Embed an interior-sized array into a zero ghost ring."""
    return torch.nn.functional.pad(values, (1, 1, 1, 1))


def add_interior(f: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``f`` plus ``values`` on the interior; the ghost ring adds zero."""
    return f + pad_interior(values)


def has_nan_or_inf(f: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor on ``f``'s device, no host read (the reference's
    src/Container.hpp:186-204)."""
    return ~torch.all(torch.isfinite(f))


def abs_max(f: torch.Tensor) -> torch.Tensor:
    """max |f| over the whole array, ghosts included (the reference's
    src/Utility.hpp abs_max)."""
    return torch.max(torch.abs(f))


def fmax(f: torch.Tensor) -> torch.Tensor:
    return torch.max(f)


def fmin(f: torch.Tensor) -> torch.Tensor:
    return torch.min(f)
