"""Uniform staggered (MAC) grid with a one-cell ghost ring.

Same conventions as ``fluidsolver_tpu.core.grid``:

  * axis 0 is the x index ``i``; axis 1 is the y index ``j``
  * a logical index ``r`` in the reference's ``[-1, N+1)`` convention maps
    to array index ``r + 1``
  * cell-centered fields (p, visc, ...): shape ``(nx+2, ny+2)``
  * U / x-face fields:                  shape ``(nx+3, ny+2)``
  * V / y-face fields:                  shape ``(nx+2, ny+3)``

The interior of a field is ``f[1:-1, 1:-1]``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

NGHOST = 1


@dataclasses.dataclass(frozen=True)
class Grid:
    """Static grid metadata; coordinates are host numpy f64 arrays."""

    nx: int
    ny: int
    x_min: float
    x_max: float
    y_min: float
    y_max: float

    def __post_init__(self):
        if self.nx <= 0 or self.ny <= 0:
            raise ValueError(f"grid extents must be positive: {self.nx}x{self.ny}")

    @property
    def dx(self) -> float:
        return (self.x_max - self.x_min) / self.nx

    @property
    def dy(self) -> float:
        return (self.y_max - self.y_min) / self.ny

    @property
    def cell_volume(self) -> float:
        return self.dx * self.dy

    # x-face coordinates, logical i in [-1, nx+1], length nx+3
    @property
    def x(self) -> np.ndarray:
        return self.x_min + np.arange(-1, self.nx + 2, dtype=np.float64) * self.dx

    # cell-center x coordinates, logical i in [-1, nx+1), length nx+2
    @property
    def xm(self) -> np.ndarray:
        return self.x_min + (np.arange(-1, self.nx + 1, dtype=np.float64) + 0.5) * self.dx

    @property
    def y(self) -> np.ndarray:
        return self.y_min + np.arange(-1, self.ny + 2, dtype=np.float64) * self.dy

    @property
    def ym(self) -> np.ndarray:
        return self.y_min + (np.arange(-1, self.ny + 1, dtype=np.float64) + 0.5) * self.dy

    @property
    def shape_center(self) -> tuple[int, int]:
        return (self.nx + 2, self.ny + 2)

    @property
    def shape_u(self) -> tuple[int, int]:
        return (self.nx + 3, self.ny + 2)

    @property
    def shape_v(self) -> tuple[int, int]:
        return (self.nx + 2, self.ny + 3)


def make_grid(x_min: float, x_max: float, nx: int, y_min: float, y_max: float, ny: int) -> Grid:
    return Grid(nx=nx, ny=ny, x_min=x_min, x_max=x_max, y_min=y_min, y_max=y_max)
