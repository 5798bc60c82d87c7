"""Kernel 1, ``fused_rap``: one BoxMG level's setup (collapsed weights and
Galerkin coarse operator) in one launch.

CUDA source: ``csrc/fused_rap.cu``; replaces the TPU kernel
``fluidsolver_tpu/poisson/pallas_rap.py:250``. The plain PyTorch twin is
``boxmg.collapse_weights`` + ``boxmg.galerkin_closed``.
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.poisson import _kernels
from fluidsolver_tpu_torch.poisson.boxmg import (BoxTransfer, Operator, Stencil9,
                                                 coefs, collapse_weights,
                                                 galerkin_closed)


def fused_rap_twin(op: Operator) -> tuple[BoxTransfer, Stencil9]:
    """(transfer weights, coarse operator): the plain PyTorch version."""
    tr = collapse_weights(op)
    return tr, galerkin_closed(op, tr, tuple(op.aC.shape))


def fused_rap_cuda(op: Operator) -> tuple[BoxTransfer, Stencil9]:
    """Launch the kernel. The 17 outputs are views of one buffer."""
    planes = coefs(op)
    ref = planes[0]
    _kernels.check(planes, ref.device, ref.dtype)
    N, M = ref.shape
    Nc, Mc = (N + 1) // 2, (M + 1) // 2
    out = torch.empty((17, Nc, Mc), dtype=ref.dtype, device=ref.device)
    outs = list(out.unbind(0))
    op_ptrs, out_ptrs = _kernels.ptrs(planes), _kernels.ptrs(outs)
    rc = _kernels.lib().fs_fused_rap(_kernels.dtype_code(ref.dtype), len(planes), op_ptrs,
                                     N, M, out_ptrs, _kernels.stream(ref.device))
    _kernels.raise_on_error(rc, "fused_rap")
    return BoxTransfer(*outs[:8]), Stencil9(*outs[8:])


def fused_rap(op: Operator) -> tuple[BoxTransfer, Stencil9]:
    """Dispatch: the kernel for CUDA tensors, the twin for CPU tensors."""
    return fused_rap_twin(op) if _kernels.on_cpu(op.aC) else fused_rap_cuda(op)
