"""XDMF2 + HDF5 time-series writer: port of ``fluidsolver_tpu.io.xdmf``.

Format parity with the reference's ``XDMFWriter`` (src/XDMFWriter.hpp:14-259):
one HDF5 dataset group per step, datasets stored in Fortran order
(README.md:20-22 documents the quirk — kept for ParaView parity), plus an
XDMF2 XML temporal collection referencing them. Requires h5py; gated so the
package works without it (``io/writer.py`` then writes VTK)."""

from __future__ import annotations

import os
from typing import Callable, List, Tuple

import numpy as np

try:
    import h5py

    HAS_H5PY = True
except Exception:  # pragma: no cover
    HAS_H5PY = False


class XDMFWriter:
    def __init__(self, directory: str, grid):
        if not HAS_H5PY:
            raise RuntimeError("h5py is unavailable; use VTKWriter instead")
        self.directory = directory
        self.grid = grid
        os.makedirs(directory, exist_ok=True)
        self._scalars: List[Tuple[str, Callable]] = []
        self._vectors: List[Tuple[str, Callable, Callable]] = []
        self._times: List[float] = []
        self.h5_path = os.path.join(directory, "data.h5")
        self.xdmf_path = os.path.join(directory, "data.xdmf")
        self._h5 = h5py.File(self.h5_path, "w")
        xm = grid.xm[1:-1]
        ym = grid.ym[1:-1]
        self._h5.create_dataset("grid/x", data=xm)
        self._h5.create_dataset("grid/y", data=ym)

    def add_scalar(self, name: str, getter: Callable):
        self._scalars.append((name, getter))

    def add_vector(self, name: str, get_x: Callable, get_y: Callable):
        self._vectors.append((name, get_x, get_y))

    def write(self, t: float) -> None:
        step = len(self._times)
        grp = self._h5.create_group(f"step_{step:06d}")
        grp.attrs["time"] = t
        # getters return host arrays (numpy or CPU tensors), as for VTKWriter
        for name, getter in self._scalars:
            arr = np.asarray(getter())[1:-1, 1:-1]
            # Fortran order on disk (reference quirk, README.md:20-22)
            grp.create_dataset(name, data=np.asfortranarray(arr.T))
        for name, gx, gy in self._vectors:
            ax = np.asarray(gx())[1:-1, 1:-1]
            ay = np.asarray(gy())[1:-1, 1:-1]
            grp.create_dataset(f"{name}_x", data=np.asfortranarray(ax.T))
            grp.create_dataset(f"{name}_y", data=np.asfortranarray(ay.T))
        self._h5.flush()
        self._times.append(t)
        self._write_xdmf()

    def _write_xdmf(self) -> None:
        g = self.grid
        nx, ny = g.nx, g.ny
        h5name = os.path.basename(self.h5_path)
        parts = [
            '<?xml version="1.0" ?>',
            '<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>',
            '<Xdmf Version="2.0">',
            " <Domain>",
            '  <Grid Name="TimeSeries" GridType="Collection" CollectionType="Temporal">',
        ]
        for step, t in enumerate(self._times):
            parts += [
                f'   <Grid Name="step_{step:06d}" GridType="Uniform">',
                f'    <Time Value="{t:.12e}"/>',
                f'    <Topology TopologyType="2DRectMesh" Dimensions="{ny} {nx}"/>',
                '    <Geometry GeometryType="VXVY">',
                f'     <DataItem Dimensions="{nx}" Format="HDF">{h5name}:/grid/x</DataItem>',
                f'     <DataItem Dimensions="{ny}" Format="HDF">{h5name}:/grid/y</DataItem>',
                "    </Geometry>",
            ]
            for name, _ in self._scalars:
                parts += [
                    f'    <Attribute Name="{name}" AttributeType="Scalar" Center="Node">',
                    f'     <DataItem Dimensions="{ny} {nx}" Format="HDF">'
                    f"{h5name}:/step_{step:06d}/{name}</DataItem>",
                    "    </Attribute>",
                ]
            for name, _, _ in self._vectors:
                for comp in ("x", "y"):
                    parts += [
                        f'    <Attribute Name="{name}_{comp}" AttributeType="Scalar" Center="Node">',
                        f'     <DataItem Dimensions="{ny} {nx}" Format="HDF">'
                        f"{h5name}:/step_{step:06d}/{name}_{comp}</DataItem>",
                        "    </Attribute>",
                    ]
            parts.append("   </Grid>")
        parts += ["  </Grid>", " </Domain>", "</Xdmf>"]
        with open(self.xdmf_path, "w") as f:
            f.write("\n".join(parts) + "\n")

    def close(self):
        self._h5.close()
