"""Global numerical constants: a torch-only copy of ``fluidsolver_tpu.constants``."""

from __future__ import annotations

import torch

# Mixed-cell cutoffs for the VOF fraction (reference values, f64).
VF_LOW = 1e-8
VF_HIGH = 1.0 - VF_LOW


def vf_cutoffs(dtype: torch.dtype) -> tuple[float, float]:
    """Dtype-aware mixed-cell cutoffs (low, high = 1 - low): the reference's
    1e-8 in f64, 64 * eps(dtype) where that is larger (f32: 2**-17, about
    7.63e-6), so that advected full cells at 1 - O(eps) stay full. Every
    mixed-cell test of the port, in PyTorch or in a kernel, uses these."""
    low = max(VF_LOW, 64.0 * float(torch.finfo(dtype).eps))
    return low, 1.0 - low
