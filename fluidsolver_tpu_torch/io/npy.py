""".npy state dumps and state restore: port of ``fluidsolver_tpu.io.npy``.

The reference writes every FS field, including the ``old`` state (a
complete restart image), as .npy v1.0 files but has no loader
(src/IO.hpp:231-269). Here both directions exist. The file names are the
JAX package's (``flow.U.npy``, ``vf.npy``, ..., ``x/y/xm/ym.npy``), so a
dump written by either package loads into the other.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


def _state_arrays(state) -> dict:
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            for k, a in _state_arrays(v).items():
                out[f"{f.name}.{k}"] = a
        else:
            out[f.name] = v.detach().cpu().numpy()
    return out


def save_state_npy(directory: str, state, grid=None) -> None:
    """One .npy per field (like to_npy, src/IO.hpp:231-269) + grid coords."""
    os.makedirs(directory, exist_ok=True)
    for name, arr in _state_arrays(state).items():
        np.save(os.path.join(directory, f"{name}.npy"), arr)
    if grid is not None:
        np.save(os.path.join(directory, "x.npy"), grid.x)
        np.save(os.path.join(directory, "y.npy"), grid.y)
        np.save(os.path.join(directory, "xm.npy"), grid.xm)
        np.save(os.path.join(directory, "ym.npy"), grid.ym)


def load_state_npy(directory: str, template):
    """Rebuild a state from a dump. ``template`` (a state of the same
    structure) gives each field's dtype and device."""

    def rebuild(obj, prefix=""):
        kwargs = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = f"{prefix}{f.name}"
            if dataclasses.is_dataclass(v):
                kwargs[f.name] = rebuild(v, prefix=f"{key}.")
            else:
                arr = np.load(os.path.join(directory, f"{key}.npy"))
                kwargs[f.name] = torch.as_tensor(arr, dtype=v.dtype, device=v.device)
        return dataclasses.replace(obj, **kwargs)

    return rebuild(template)
