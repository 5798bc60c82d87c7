"""Kernels 3 and 4: the BoxMG coarse tail's setup (``build_tail_pack``) and
its whole V-cycle (``tail_cycle``), one launch each.

CUDA source: ``csrc/tail.cu``; replaces the TPU kernels
``fluidsolver_tpu/poisson/pallas_tail.py:403`` (``build_tail_pack_fused``)
and ``:455`` (``tail_cycle``). The plain PyTorch twins run
``boxmg.collapse_weights`` + ``boxmg.galerkin_closed`` per level, and the
V-cycle recursion of ``boxmg`` with COARSE_SWEEPS symmetric sweeps on the
coarsest level.
"""

from __future__ import annotations

import dataclasses

import torch

from fluidsolver_tpu_torch.poisson import _kernels
from fluidsolver_tpu_torch.poisson.boxmg import (COARSE_SWEEPS, MAX_TAIL_LEVELS,
                                                 WEIGHT_NAMES, BoxTransfer, Operator, Stencil9,
                                                 _rb_sweep, apply_any, coefs,
                                                 collapse_weights, galerkin_closed,
                                                 prolong_box, restrict_box)


def level_shapes(shape, n_levels: int) -> list:
    shapes = [tuple(shape)]
    for _ in range(n_levels - 1):
        n, m = shapes[-1]
        shapes.append(((n + 1) // 2, (m + 1) // 2))
    return shapes


@dataclasses.dataclass
class TailPack:
    """Every level of the tail. ``buf`` holds, per level d < n_levels - 1,
    the 8 weight planes of the transfer d -> d+1 and then the 9 coefficient
    planes of level d+1, each (Nc_d, Mc_d) contiguous (the layout of
    csrc/tail.cu)."""

    op0: Operator      # the tail-finest operator (5- or 9-point)
    shapes: tuple
    buf: torch.Tensor

    def _planes(self, d: int) -> list:
        off = 0
        for nc, mc in self.shapes[1:d + 1]:
            off += 17 * nc * mc
        nc, mc = self.shapes[d + 1]
        return list(self.buf[off:off + 17 * nc * mc].view(17, nc, mc).unbind(0))

    @property
    def trs(self) -> list:
        return [BoxTransfer(*self._planes(d)[:8]) for d in range(len(self.shapes) - 1)]

    @property
    def ops(self) -> list:
        return [self.op0] + [Stencil9(*self._planes(d)[8:]) for d in range(len(self.shapes) - 1)]


def _empty_pack(op0: Operator, n_levels: int) -> TailPack:
    if not 2 <= n_levels <= MAX_TAIL_LEVELS:
        raise ValueError(f"a tail has 2..{MAX_TAIL_LEVELS} levels, not {n_levels}")
    shapes = level_shapes(op0.aC.shape, n_levels)
    size = sum(17 * n * m for n, m in shapes[1:])
    buf = torch.empty(size, dtype=op0.aC.dtype, device=op0.aC.device)
    return TailPack(op0=op0, shapes=tuple(shapes), buf=buf)


def pack_levels(ops: list, trs: list) -> TailPack:
    """A ``TailPack`` holding the given levels (``ops[d+1]`` is the coarse
    operator of ``trs[d]``)."""
    pack = _empty_pack(ops[0], len(ops))
    for d, (tr, op) in enumerate(zip(trs, ops[1:])):
        planes = pack._planes(d)
        for dst, src in zip(planes, [getattr(tr, n) for n in WEIGHT_NAMES] + coefs(op)):
            dst.copy_(src)
    return pack


def build_tail_pack_twin(op0: Operator, n_levels: int) -> TailPack:
    """The plain PyTorch tail setup."""
    ops, trs = [op0], []
    for _ in range(n_levels - 1):
        tr = collapse_weights(ops[-1])
        ops.append(galerkin_closed(ops[-1], tr, tuple(ops[-1].aC.shape)))
        trs.append(tr)
    return pack_levels(ops, trs)


def build_tail_pack_cuda(op0: Operator, n_levels: int) -> TailPack:
    """Launch the setup kernel."""
    pack = _empty_pack(op0, n_levels)
    planes = coefs(op0)
    _kernels.check(planes, pack.buf.device, pack.buf.dtype)
    N, M = pack.shapes[0]
    rc = _kernels.lib().fs_tail_setup(
        _kernels.dtype_code(pack.buf.dtype), len(planes), _kernels.ptrs(planes), N, M,
        n_levels, pack.buf.data_ptr(), _kernels.stream(pack.buf.device))
    _kernels.raise_on_error(rc, "tail_setup")
    return pack


def build_tail_pack(op0: Operator, n_levels: int) -> TailPack:
    """Build every tail level below ``op0`` (``n_levels`` levels in all).
    Dispatch: the kernel for CUDA tensors, the twin for CPU tensors."""
    return (build_tail_pack_twin if _kernels.on_cpu(op0.aC) else build_tail_pack_cuda)(op0, n_levels)


def tail_cycle_twin(pack: TailPack, b, n_pre: int = 1, n_post: int = 1):
    """The plain PyTorch tail V-cycle."""
    ops, trs = pack.ops, pack.trs

    def cycle(d, b_d):
        x = torch.zeros_like(b_d)
        if d == len(ops) - 1:
            for _ in range(COARSE_SWEEPS // 2):
                x = _rb_sweep(ops[d], x, b_d)
                x = _rb_sweep(ops[d], x, b_d, reverse=True)
            return x
        for _ in range(n_pre):
            x = _rb_sweep(ops[d], x, b_d)
        ec = cycle(d + 1, restrict_box(trs[d], b_d - apply_any(ops[d], x)))
        x = x + prolong_box(trs[d], ec, b_d.shape)
        for _ in range(n_post):
            x = _rb_sweep(ops[d], x, b_d, reverse=True)
        return x

    return cycle(0, b)


def tail_cycle_cuda(pack: TailPack, b, n_pre: int = 1, n_post: int = 1):
    """Launch the cycle kernel."""
    planes = coefs(pack.op0)
    _kernels.check(planes + [pack.buf, b], b.device, b.dtype)
    if tuple(b.shape) != pack.shapes[0]:
        raise ValueError(f"b has shape {tuple(b.shape)}, the tail {pack.shapes[0]}")
    x = torch.empty_like(b)
    scratch = b.new_empty(sum(4 * n * m for n, m in pack.shapes))
    N, M = pack.shapes[0]
    rc = _kernels.lib().fs_tail_cycle(
        _kernels.dtype_code(b.dtype), len(planes), _kernels.ptrs(planes), pack.buf.data_ptr(),
        b.data_ptr(), x.data_ptr(), scratch.data_ptr(), N, M, len(pack.shapes), n_pre, n_post,
        _kernels.stream(b.device))
    _kernels.raise_on_error(rc, "tail_cycle")
    return x


def tail_cycle(pack: TailPack, b, n_pre: int = 1, n_post: int = 1):
    """One V(n_pre, n_post) cycle over the whole tail from a zero guess; the
    coarsest level runs COARSE_SWEEPS symmetric sweeps. Dispatch: the
    kernel for CUDA tensors, the twin for CPU tensors."""
    return (tail_cycle_twin if _kernels.on_cpu(b) else tail_cycle_cuda)(pack, b, n_pre, n_post)
