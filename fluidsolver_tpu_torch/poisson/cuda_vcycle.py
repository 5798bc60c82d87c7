"""Kernel 2, ``fused_smooth``: one red-black smoothing phase on a BoxMG
level in one launch, optionally with the residual, the restriction epilogue
or the prolongation+correction prologue.

CUDA source: ``csrc/fused_smooth.cu``; replaces the TPU kernel
``fluidsolver_tpu/poisson/pallas_vcycle.py:357``. The plain PyTorch twin
chains ``boxmg.color_update`` half-steps with ``boxmg.restrict_box`` /
``boxmg.prolong_box``.

bf16 operands (a hierarchy cast by ``boxmg.cast_hierarchy``) are stored in
bf16 and computed in f32, the TPU kernel's contract
(``pallas_vcycle.py:118-125``): the twin casts the operands up to f32, runs
the f32 twin and casts the outputs down, so the phase rounds once, on its
outputs.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidsolver_tpu_torch.poisson import _kernels
from fluidsolver_tpu_torch.poisson.boxmg import (WEIGHT_NAMES, BoxTransfer, Operator,
                                                 apply_any, cast_struct, coefs,
                                                 color_update, prolong_box, restrict_box)

MAX_HALO = 8  # csrc/fused_smooth.cu kMaxHalo: half-steps + residual depth
_PLAIN, _RESIDUAL, _RESTRICT = 0, 1, 2


def _check_variant(colors, residual, restrict, tr, ec):
    if residual and restrict:
        raise ValueError("residual and restrict are exclusive")
    if (restrict or ec is not None) and tr is None:
        raise ValueError("restrict and ec need the transfer weights tr")
    if ec is not None and (residual or restrict):
        raise ValueError("the ec prologue runs with the plain variant only")
    if len(colors) + (2 if restrict else 1 if residual else 0) > MAX_HALO:
        raise ValueError(f"too many half-steps for one phase: {len(colors)}")


def fused_smooth_twin(op: Operator, b, x0=None, colors=(), residual=False,
                      tr: Optional[BoxTransfer] = None, restrict=False, ec=None):
    """The plain PyTorch version (same contract as :func:`fused_smooth`)."""
    _check_variant(colors, residual, restrict, tr, ec)
    compute = torch.promote_types(b.dtype, torch.float32)
    if compute != b.dtype:
        # narrow storage: the f32 twin on the widened operands, rounded once
        up = [None if t is None else t.to(compute) for t in (x0, ec)]
        out = fused_smooth_twin(cast_struct(op, compute), b.to(compute), up[0], colors, residual,
                                cast_struct(tr, compute), restrict, up[1])
        return tuple(t.to(b.dtype) for t in out) if isinstance(out, tuple) else out.to(b.dtype)
    x = torch.zeros_like(b) if x0 is None else x0
    if ec is not None:
        x = x + prolong_box(tr, ec, b.shape)
    for red in colors:
        x = color_update(op, x, b, red)
    if residual:
        return x, b - apply_any(op, x)
    if restrict:
        return x, restrict_box(tr, b - apply_any(op, x))
    return x


def fused_smooth_cuda(op: Operator, b, x0=None, colors=(), residual=False,
                      tr: Optional[BoxTransfer] = None, restrict=False, ec=None):
    """Launch the kernel (same contract as :func:`fused_smooth`). Every
    launch counts as ``fused_smooth``; a bf16 one also as
    ``fused_smooth_bf16``."""
    _check_variant(colors, residual, restrict, tr, ec)
    planes = coefs(op)
    wplanes = [getattr(tr, n) for n in WEIGHT_NAMES] if tr is not None else []
    optional = [t for t in (x0, ec) if t is not None]
    _kernels.check(planes + [b] + wplanes + optional, b.device, b.dtype)
    N, M = b.shape
    Nc, Mc = (N + 1) // 2, (M + 1) // 2
    if any(p.shape != (N, M) for p in planes) or (x0 is not None and x0.shape != (N, M)):
        raise ValueError("operator planes, b and x0 must share one shape")
    if any(w.shape != (Nc, Mc) for w in wplanes) or (ec is not None and ec.shape != (Nc, Mc)):
        raise ValueError(f"weights and ec must be coarse-shaped {(Nc, Mc)}")
    x = torch.empty_like(b)
    mode = _RESTRICT if restrict else _RESIDUAL if residual else _PLAIN
    r = (b.new_empty((Nc, Mc)) if restrict else torch.empty_like(b)) if mode else None
    mask = sum(1 << s for s, red in enumerate(colors) if red)
    op_ptrs = _kernels.ptrs(planes)
    tr_ptrs = _kernels.ptrs(wplanes) if wplanes else None
    rc = _kernels.lib().fs_fused_smooth(
        _kernels.dtype_code(b.dtype), len(planes), op_ptrs, b.data_ptr(),
        None if x0 is None else x0.data_ptr(), tr_ptrs,
        None if ec is None else ec.data_ptr(), Nc, Mc, x.data_ptr(),
        None if r is None else r.data_ptr(), N, M, mask, len(colors), mode,
        _kernels.stream(b.device))
    _kernels.raise_on_error(rc, "fused_smooth")
    if b.dtype == torch.bfloat16:
        _kernels.launches["fused_smooth_bf16"] += 1
    return x if r is None else (x, r)


def fused_smooth(op: Operator, b, x0=None, colors=(), residual=False,
                 tr: Optional[BoxTransfer] = None, restrict=False, ec=None):
    """Run the half-steps ``colors`` (True = red, i.e. (i + j) even) from
    ``x0`` (or zero); exactly ``boxmg.color_update`` chained.

    ``residual=True`` also returns r = b - A x. With the transfer weights
    ``tr``: ``restrict=True`` also returns P^T (b - A x) (the coarse
    right-hand side), and a coarse error ``ec`` starts the phase from
    x0 + P ec. Dispatch: the kernel for CUDA tensors, the twin for CPU."""
    impl = fused_smooth_twin if _kernels.on_cpu(b) else fused_smooth_cuda
    return impl(op, b, x0=x0, colors=colors, residual=residual, tr=tr,
                restrict=restrict, ec=ec)
