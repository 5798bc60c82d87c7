"""Kernel 11, ``curvature``: the volume-matching quadratic curvature of every
interior mixed cell in one launch.

CUDA source: ``csrc/curvature.cu`` (one block per strip of cells: the
zeros, a shared list of the strip's valid cells, one thread a (cell,
neighbour) segment, one thread a cell's fit); replaces the
TPU kernel ``fluidsolver_tpu/vof/pallas_curvature.py:92``. The kernel
rotates with acos/cos/sin as the JAX package's plain path does (the TPU
kernel's trig-free rotation agrees with it only to about 1e-6). The plain
PyTorch twin is ``curvature.vm_core`` on the shifted interior views of the
segment endpoints.
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.core.fields import pad_interior
from fluidsolver_tpu_torch.poisson import _kernels
from fluidsolver_tpu_torch.vof.curvature import vm_core
from fluidsolver_tpu_torch.vof.plic import NEIGHBOR_OFFSETS, segment_endpoints_vals, shift


def curvature_vm_twin(nx, ny, d, valid, dx: float, dy: float) -> torch.Tensor:
    """The plain PyTorch version."""
    seg = segment_endpoints_vals(nx, ny, d, dx, dy)
    nb = {(di, dj): tuple(shift(f, di, dj) for f in (*seg, valid)) for di, dj in NEIGHBOR_OFFSETS}
    return pad_interior(vm_core(nb, shift(nx, 0, 0), shift(ny, 0, 0), dx, dy))


def curvature_vm_cuda(nx, ny, d, valid, dx: float, dy: float) -> torch.Tensor:
    """Launch the kernel; ``valid`` is a bool plane (read as uint8)."""
    _kernels.check([nx, ny, d], nx.device, nx.dtype)
    if valid.dtype != torch.bool or valid.device != nx.device or not valid.is_contiguous():
        raise ValueError("valid must be a contiguous bool tensor on the planes' device")
    N, M = nx.shape
    if ny.shape != (N, M) or d.shape != (N, M) or valid.shape != (N, M):
        raise ValueError("nx, ny, d and valid must share one shape")
    out = torch.empty_like(nx)
    rc = _kernels.lib().fs_curvature(_kernels.dtype_code(nx.dtype), nx.data_ptr(), ny.data_ptr(),
                                     d.data_ptr(), valid.data_ptr(), N, M, float(dx), float(dy),
                                     out.data_ptr(), _kernels.stream(nx.device))
    _kernels.raise_on_error(rc, "curvature")
    return out


def curvature_vm(nx, ny, d, valid, dx: float, dy: float) -> torch.Tensor:
    """Curvature over the full ghost box from the PLIC planes (0 off the
    valid cells). Dispatch: the kernel for CUDA tensors, the twin for CPU."""
    impl = curvature_vm_twin if _kernels.on_cpu(nx) else curvature_vm_cuda
    return impl(nx, ny, d, valid, dx, dy)
