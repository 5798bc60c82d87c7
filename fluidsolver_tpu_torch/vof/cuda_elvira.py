"""Kernel 10, ``elvira``: the 12-candidate ELVIRA reconstruction of every
interior mixed cell in one launch.

CUDA source: ``csrc/elvira.cu`` (one block per tile: the fills, then the
tile's mixed cells' candidates spread over the block's threads); replaces the TPU kernel ``fluidsolver_tpu/vof/pallas_elvira.py:51``. The
plain PyTorch twin runs ``plic.elvira_candidates`` on the shifted interior
views and masks the result to the interior mixed cells with the fills
(0, 1, 0), which is what the JAX package's sparse path and its TPU kernel
leave on the other cells.
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.constants import vf_cutoffs
from fluidsolver_tpu_torch.poisson import _kernels
from fluidsolver_tpu_torch.vof.plic import (NEIGHBOR_OFFSETS, Plic, elvira_candidates,
                                            has_interface, shift)

FILLS = (0.0, 1.0, 0.0)  # (nx, ny, d) where there is no reconstruction


def _no_overflow(vf):
    return torch.zeros((), dtype=torch.bool, device=vf.device)


def elvira_twin(vf: torch.Tensor, dx: float, dy: float) -> Plic:
    """The plain PyTorch version."""
    vfn = {(di, dj): shift(vf, di, dj) for di, dj in NEIGHBOR_OFFSETS}
    best = elvira_candidates(vfn, dx, dy)
    mixed = has_interface(vfn[(0, 0)])
    planes = []
    for value, fill in zip(best, FILLS):
        out = torch.full_like(vf, fill)
        out[1:-1, 1:-1] = torch.where(mixed, value, torch.full_like(value, fill))
        planes.append(out)
    valid = torch.zeros(vf.shape, dtype=torch.bool, device=vf.device)
    valid[1:-1, 1:-1] = mixed
    return Plic(*planes, valid=valid, overflow=_no_overflow(vf))


def elvira_cuda(vf: torch.Tensor, dx: float, dy: float) -> Plic:
    """Launch the kernel. nx, ny, d are views of one (3, N, M) buffer;
    ``valid`` is the kernel's uint8 plane viewed as bool."""
    _kernels.check([vf], vf.device, vf.dtype)
    N, M = vf.shape
    out = torch.empty((3, N, M), dtype=vf.dtype, device=vf.device)
    valid = torch.empty((N, M), dtype=torch.uint8, device=vf.device)
    lo, hi = vf_cutoffs(vf.dtype)
    rc = _kernels.lib().fs_elvira(_kernels.dtype_code(vf.dtype), vf.data_ptr(), N, M,
                                  float(dx), float(dy), lo, hi, out.data_ptr(),
                                  valid.data_ptr(), _kernels.stream(vf.device))
    _kernels.raise_on_error(rc, "elvira")
    return Plic(out[0], out[1], out[2], valid=valid.view(torch.bool), overflow=_no_overflow(vf))


def elvira(vf: torch.Tensor, dx: float, dy: float) -> Plic:
    """Dispatch: the kernel for a CUDA tensor, the twin for a CPU tensor."""
    return elvira_twin(vf, dx, dy) if _kernels.on_cpu(vf) else elvira_cuda(vf, dx, dy)
