"""The dtype names of ``SolverConfig.pressure_precond_dtype``."""

from __future__ import annotations

import torch


def torch_dtype(name) -> torch.dtype:
    """A dtype given by name (``"bfloat16"``, ``"float32"``, ...) or as a
    torch dtype."""
    if isinstance(name, torch.dtype):
        return name
    dtype = getattr(torch, str(name), None)
    if not isinstance(dtype, torch.dtype) or not dtype.is_floating_point:
        raise ValueError(f"not a floating-point dtype: {name!r}")
    return dtype
