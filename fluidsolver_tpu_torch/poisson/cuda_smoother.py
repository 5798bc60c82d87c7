"""Kernel 9, ``rb_sweep``: one red-black Gauss-Seidel sweep (both colours)
of the 5-point operator in one launch, out of place.

CUDA source: ``csrc/rb_sweep.cu``; replaces the TPU kernel
``fluidsolver_tpu/poisson/pallas_smoother.py:54``. The plain PyTorch twin
is the JAX package's XLA sweep (``mg._rb_sweep``): two ``boxmg.color_update``
half-steps, red first unless ``reverse``.

The JAX package takes its kernel only on a TPU and for a level that fits
VMEM; the port launches it on every level of a V-cycle on CUDA tensors.

On bf16 operands (the "mg" hierarchy of ``pressure_precond_dtype=
"bfloat16"``) the sweep computes in bf16, as the TPU kernel does: the twin
is ``color_update`` chained on bf16 tensors, each PyTorch operation
rounding its result, and the kernel rounds after every operation in the
same order (``csrc/bf16.cuh`` ``bf16r``).
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.poisson import _kernels
from fluidsolver_tpu_torch.poisson.boxmg import coefs, color_update
from fluidsolver_tpu_torch.poisson.linsys import StencilOp


def rb_sweep_twin(op: StencilOp, x, b, reverse: bool = False):
    """The plain PyTorch version (same contract as :func:`rb_sweep`)."""
    x = color_update(op, x, b, not reverse)
    return color_update(op, x, b, reverse)


def rb_sweep_cuda(op: StencilOp, x, b, reverse: bool = False):
    """Launch the kernel (same contract as :func:`rb_sweep`). Every launch
    counts as ``rb_sweep``; a bf16 one also as ``rb_sweep_bf16``."""
    planes = coefs(op)
    _kernels.check(planes + [b, x], b.device, b.dtype)
    if any(t.shape != b.shape for t in planes + [x]) or b.dim() != 2:
        raise ValueError("operator planes, x and b must share one 2-D shape")
    out = torch.empty_like(x)
    N, M = b.shape
    rc = _kernels.lib().fs_rb_sweep(
        _kernels.dtype_code(b.dtype), _kernels.ptrs(planes), b.data_ptr(), x.data_ptr(),
        out.data_ptr(), N, M, int(not reverse), _kernels.stream(b.device))
    _kernels.raise_on_error(rc, "rb_sweep")
    if b.dtype == torch.bfloat16:
        _kernels.launches["rb_sweep_bf16"] += 1
    return out


def rb_sweep(op: StencilOp, x, b, reverse: bool = False):
    """One red-black Gauss-Seidel sweep of A x = b: every red point ((i + j)
    even) gets (b - (A x - aC x)) / aC (aC = 0 divides by 1, neighbours
    outside the level are zero), then every black point from the new red
    values; black first when ``reverse``. Dispatch: the kernel for CUDA
    tensors, the twin for CPU tensors."""
    impl = rb_sweep_twin if _kernels.on_cpu(b) else rb_sweep_cuda
    return impl(op, x, b, reverse)
