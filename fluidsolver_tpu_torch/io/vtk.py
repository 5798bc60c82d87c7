"""Legacy VTK writer: port of ``fluidsolver_tpu.io.vtk``. Binary
STRUCTURED_GRID, big-endian, with a scalar/vector registry: format parity
with the reference's ``VTKWriter`` (src/VTKWriter.hpp:14-153), so existing
ParaView pipelines keep working. Interior cell-centered values are written
on the cell-center grid; for the same values the file is byte-identical to
the JAX package's."""

from __future__ import annotations

import os
from typing import Callable, List, Tuple

import numpy as np


class VTKWriter:
    """Registry-based time-series writer; one .vtk file per write call."""

    def __init__(self, directory: str, grid):
        self.directory = directory
        self.grid = grid
        os.makedirs(directory, exist_ok=True)
        self._scalars: List[Tuple[str, Callable]] = []
        self._vectors: List[Tuple[str, Callable, Callable]] = []
        self._counter = 0

    def add_scalar(self, name: str, getter: Callable):
        """getter() -> cell-centered ghosted host array (numpy or a CPU
        tensor); its interior is written."""
        self._scalars.append((name, getter))

    def add_vector(self, name: str, get_x: Callable, get_y: Callable):
        self._vectors.append((name, get_x, get_y))

    def write(self, t: float) -> str:
        g = self.grid
        nx, ny = g.nx, g.ny
        path = os.path.join(self.directory, f"state_{self._counter:06d}.vtk")
        self._counter += 1
        xm = g.xm[1:-1]
        ym = g.ym[1:-1]
        with open(path, "wb") as f:
            f.write(b"# vtk DataFile Version 2.0\n")
            f.write(f"time: {t:.12e}\n".encode())
            f.write(b"BINARY\n")
            f.write(b"DATASET STRUCTURED_GRID\n")
            f.write(f"DIMENSIONS {nx} {ny} 1\n".encode())
            f.write(f"POINTS {nx * ny} double\n".encode())
            # VTK structured order: x fastest
            X, Y = np.meshgrid(xm, ym, indexing="xy")  # (ny, nx)
            pts = np.zeros((ny, nx, 3))
            pts[..., 0] = X
            pts[..., 1] = Y
            f.write(pts.astype(">f8").tobytes())
            f.write(f"\nPOINT_DATA {nx * ny}\n".encode())
            for name, getter in self._scalars:
                arr = np.asarray(getter())[1:-1, 1:-1]  # (nx, ny)
                f.write(f"SCALARS {name} double 1\n".encode())
                f.write(b"LOOKUP_TABLE default\n")
                f.write(arr.T.astype(">f8").tobytes())  # x fastest
                f.write(b"\n")
            for name, get_x, get_y in self._vectors:
                ax = np.asarray(get_x())[1:-1, 1:-1]
                ay = np.asarray(get_y())[1:-1, 1:-1]
                vec = np.zeros((ny, nx, 3))
                vec[..., 0] = ax.T
                vec[..., 1] = ay.T
                f.write(f"VECTORS {name} double\n".encode())
                f.write(vec.astype(">f8").tobytes())
                f.write(b"\n")
        return path


def save_interface_vtk(filename: str, rec, grid) -> None:
    """PLIC interface polylines of the reconstruction ``rec`` (a
    ``vof.plic.Plic``) as legacy VTK POLYDATA (src/VOF.hpp:425-495)."""
    from fluidsolver_tpu_torch.vof.plic import segment_endpoints

    x0s, y0s, x1s, y1s = (a.detach().cpu().numpy()
                          for a in segment_endpoints(rec, grid.dx, grid.dy))
    valid = rec.valid.detach().cpu().numpy()
    ii, jj = np.where(valid)
    # shift from cell-local to global coordinates
    x0 = grid.x[:-1]
    y0 = grid.y[:-1]
    pts = []
    for i, j in zip(ii, jj):
        ox, oy = x0[i], y0[j]
        pts.append((x0s[i, j] + ox, y0s[i, j] + oy, 0.0))
        pts.append((x1s[i, j] + ox, y1s[i, j] + oy, 0.0))
    pts_arr = np.asarray(pts, dtype=">f8") if pts else np.zeros((0, 3), ">f8")
    n = len(pts)
    with open(filename, "wb") as out:
        out.write(b"# vtk DataFile Version 2.0\n")
        out.write(b"VOF field\n")
        out.write(b"BINARY\n")
        out.write(b"DATASET POLYDATA\n")
        out.write(f"POINTS {n} double\n".encode())
        out.write(pts_arr.tobytes())
        out.write(b"\n\n")
        out.write(f"LINES {3} {n // 2 * 3}\n".encode())
        lines = np.zeros((n // 2, 3), ">u4")
        lines[:, 0] = 2
        lines[:, 1] = np.arange(0, n, 2)
        lines[:, 2] = np.arange(1, n, 2)
        out.write(lines.tobytes())
