"""DataWriter facade + save cadence: port of ``fluidsolver_tpu.io.writer``.

Mirrors the reference's writer selection (src/IO.hpp:13-21: XDMF+HDF5 by
default, VTK when HDF5 is unavailable, i.e. without h5py) and its
``should_save`` cadence (src/IO.hpp:98-108).
"""

from __future__ import annotations

import math


def make_data_writer(directory: str, grid, prefer: str = "xdmf"):
    if prefer == "xdmf":
        from fluidsolver_tpu_torch.io.xdmf import XDMFWriter

        try:
            return XDMFWriter(directory, grid)
        except RuntimeError:  # no h5py: the reference's VTK choice
            pass
    from fluidsolver_tpu_torch.io.vtk import VTKWriter

    return VTKWriter(directory, grid)


class SaveCadence:
    """Stateful form of should_save (src/IO.hpp:98-108)."""

    DT_SAFE = 1e-6

    def __init__(self, dt_write: float, t_end: float):
        self.dt_write = dt_write
        self.t_end = t_end
        self._last_save_t = -1.0

    def __call__(self, t: float, dt: float) -> bool:
        dt_write_complete = math.fmod(t + self.DT_SAFE * dt, self.dt_write) < dt * (
            1.0 - self.DT_SAFE
        )
        is_last = abs(t - self.t_end) < self.DT_SAFE
        res = dt_write_complete or is_last
        if res and is_last and abs(t - self._last_save_t) < self.DT_SAFE:
            return False
        if res:
            self._last_save_t = t
        return res
