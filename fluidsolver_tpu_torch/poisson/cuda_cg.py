"""Kernels 5-7, the fused PCG iteration outside the preconditioner:
``step_ab``, ``step_c`` and ``step_init``.

CUDA source: ``csrc/cg.cu``; replaces the TPU kernels
``fluidsolver_tpu/poisson/pallas_cg.py:109`` (``step_ab``), ``:287``
(``step_c``) and ``:462`` (``step_init``), with the contracts of their
``padded_io=False`` form (the TPU band layout is not ported). Each is one
cooperative launch (a grid-wide barrier between a reduction and the values
that depend on it; ``step_init`` has up to two). Every
scalar, in or out, is a 0-d tensor on the vectors' device: nothing is read
back to the host.

The plain PyTorch twins follow the kernels' algebra (e.g. the projected dot
rz_new = <r, z_raw> - mean(z_raw) sum_r, the mean as sum * (1 / n)) and
reduce with ``torch.sum``, so kernel and twin differ only in the order of
their sums.
"""

from __future__ import annotations

from typing import Optional

import torch

from fluidsolver_tpu_torch.poisson import _kernels
from fluidsolver_tpu_torch.poisson.linsys import StencilOp, apply_op

PARTIALS = 6 * 1024  # csrc/cg.cu: kMaxSums * kMaxBlocks per-block partial sums
_SCALARS = 8


def _safe(d):
    return torch.where(d != 0.0, d, torch.ones_like(d))


def _planes(op: StencilOp) -> list:
    return [op.aC, op.aL, op.aR, op.aB, op.aT]


def _check(tensors, scalars, shape, like) -> None:
    _kernels.check(tensors + scalars, like.device, like.dtype)
    if any(t.shape != shape for t in tensors):
        raise ValueError(f"operator planes and vectors must share the shape {shape}")
    if any(s.numel() != 1 for s in scalars):
        raise ValueError("scalar operands must hold one value")


def _scratch(like):
    return like.new_empty(PARTIALS), like.new_empty(_SCALARS)


# ---- step_ab -----------------------------------------------------------------
def step_ab_twin(op: StencilOp, x, r, p, rz):
    """The plain PyTorch version (same contract as :func:`step_ab`)."""
    Ap = apply_op(op, p)
    pAp = torch.sum(p * Ap)
    alpha = rz / _safe(pAp)
    x_new = x + alpha * p
    r_new = r - alpha * Ap
    return x_new, r_new, pAp, torch.sum(r_new * r_new), torch.sum(r_new)


def step_ab_cuda(op: StencilOp, x, r, p, rz):
    """Launch the kernel (same contract as :func:`step_ab`)."""
    planes = _planes(op)
    _check(planes + [x, r, p], [rz], x.shape, x)
    N, M = x.shape
    x_out, r_out = torch.empty_like(x), torch.empty_like(x)
    part, scal = _scratch(x)
    rc = _kernels.lib().fs_step_ab(
        _kernels.dtype_code(x.dtype), _kernels.ptrs(planes), x.data_ptr(), r.data_ptr(),
        p.data_ptr(), rz.data_ptr(), N, M, x_out.data_ptr(), r_out.data_ptr(), None,
        part.data_ptr(), scal.data_ptr(), _kernels.stream(x.device))
    _kernels.raise_on_error(rc, "step_ab")
    return x_out, r_out, scal[0], scal[1], scal[2]


def step_ab(op: StencilOp, x, r, p, rz):
    """The alpha half of a PCG iteration: (x', r', pAp, rr, sum_r) with
    Ap = A p, pAp = <p, Ap>, alpha = rz / pAp (rz / 1 where pAp = 0),
    x' = x + alpha p, r' = r - alpha Ap, rr = <r', r'>, sum_r = sum(r').
    Dispatch: the kernel for CUDA tensors, the twin for CPU tensors."""
    impl = step_ab_twin if _kernels.on_cpu(x) else step_ab_cuda
    return impl(op, x, r, p, rz)


# ---- step_c ------------------------------------------------------------------
def step_c_twin(r, z_raw, p, rz_prev, singular: bool, sum_r=None):
    """The plain PyTorch version (same contract as :func:`step_c`)."""
    rz_raw = torch.sum(r * z_raw)
    if singular:
        mean = torch.sum(z_raw) * (1.0 / z_raw.numel())
        z = z_raw - mean
        rz_new = rz_raw - mean * sum_r
    else:
        z, rz_new = z_raw, rz_raw
    if p is None:
        return z, z, rz_new
    beta = rz_new / _safe(rz_prev)
    return z, z + beta * p, rz_new


def step_c_cuda(r, z_raw, p, rz_prev, singular: bool, sum_r=None):
    """Launch the kernel (same contract as :func:`step_c`)."""
    vecs = [r, z_raw] + ([] if p is None else [p])
    scalars = [rz_prev] + ([sum_r] if singular else [])
    _check(vecs, scalars, r.shape, r)
    z_out = torch.empty_like(r)
    p_out = None if p is None else torch.empty_like(r)
    part, scal = _scratch(r)
    rc = _kernels.lib().fs_step_c(
        _kernels.dtype_code(r.dtype), r.data_ptr(), z_raw.data_ptr(),
        None if p is None else p.data_ptr(), rz_prev.data_ptr(),
        sum_r.data_ptr() if singular else None, int(singular), r.numel(), z_out.data_ptr(),
        None if p_out is None else p_out.data_ptr(), part.data_ptr(), scal.data_ptr(),
        _kernels.stream(r.device))
    _kernels.raise_on_error(rc, "step_c")
    return z_out, z_out if p is None else p_out, scal[0]


def step_c(r, z_raw, p, rz_prev, singular: bool, sum_r=None):
    """The beta half of a PCG iteration: (z, p', rz_new) with z = z_raw -
    mean(z_raw) if ``singular`` (else z_raw), rz_new = <r, z> (formed as
    <r, z_raw> - mean(z_raw) sum_r; ``sum_r`` = sum(r), from ``step_ab`` or
    ``step_init``, is needed only if ``singular``), p' = z + (rz_new /
    rz_prev) p. ``p=None`` is the solve-init form (p = 0): p' is z, the same
    tensor. Dispatch: the kernel for CUDA tensors, the twin for CPU
    tensors."""
    if singular and sum_r is None:
        raise ValueError("step_c: a singular system needs sum_r = sum(r)")
    impl = step_c_twin if _kernels.on_cpu(r) else step_c_cuda
    return impl(r, z_raw, p, rz_prev, singular, sum_r=sum_r)


# ---- step_init ---------------------------------------------------------------
def step_init_twin(op: StencilOp, b, x0: Optional[torch.Tensor], singular: bool):
    """The plain PyTorch version (same contract as :func:`step_init`)."""
    inv_n = 1.0 / b.numel()
    b1 = b - torch.sum(b) * inv_n if singular else b
    bb = torch.sum(b1 * b1)
    sum_b1 = torch.sum(b1)
    if x0 is None:
        return torch.zeros_like(b), b1, bb, bb, sum_b1
    x1 = x0 - torch.sum(x0) * inv_n if singular else x0
    r_ws = b1 - apply_op(op, x1)
    rr_ws = torch.sum(r_ws * r_ws)
    good = rr_ws < bb
    return (torch.where(good, x1, torch.zeros_like(b)), torch.where(good, r_ws, b1), bb,
            torch.where(good, rr_ws, bb), torch.where(good, torch.sum(r_ws), sum_b1))


def step_init_cuda(op: StencilOp, b, x0: Optional[torch.Tensor], singular: bool):
    """Launch the kernel (same contract as :func:`step_init`)."""
    planes = _planes(op)
    _check(planes + [b] + ([] if x0 is None else [x0]), [], b.shape, b)
    N, M = b.shape
    x_out, r_out = torch.empty_like(b), torch.empty_like(b)
    part, scal = _scratch(b)
    rc = _kernels.lib().fs_step_init(
        _kernels.dtype_code(b.dtype), _kernels.ptrs(planes), b.data_ptr(),
        None if x0 is None else x0.data_ptr(), int(singular), N, M, x_out.data_ptr(),
        r_out.data_ptr(), part.data_ptr(), scal.data_ptr(), _kernels.stream(b.device))
    _kernels.raise_on_error(rc, "step_init")
    return x_out, r_out, scal[0], scal[1], scal[2]


def step_init(op: StencilOp, b, x0: Optional[torch.Tensor], singular: bool):
    """The PCG init before the first preconditioner call: (x0', r0', bb,
    rr0, sum_r0). With ``singular`` b and x0 are projected (b1 = b -
    mean(b), x1 = x0 - mean(x0)); bb = <b1, b1>. A warm start ``x0`` is
    kept iff <r_ws, r_ws> < bb for r_ws = b1 - A x1: then (x0', r0') =
    (x1, r_ws), else (0, b1), as with a cold start (``x0=None``). rr0 and
    sum_r0 are <r0', r0'> and sum(r0'). Dispatch: the kernel for CUDA
    tensors, the twin for CPU tensors."""
    impl = step_init_twin if _kernels.on_cpu(b) else step_init_cuda
    return impl(op, b, x0, singular)
