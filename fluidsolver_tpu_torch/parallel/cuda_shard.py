"""Kernel #1 on x-slabs: port of ``fluidsolver_tpu.parallel.pallas_shard``.

One smoothing phase of the distributed V-cycle runs the unchanged
single-device kernel ``csrc/fused_smooth.cu`` (``poisson/cuda_vcycle.py``)
on each halo-extended slab:

1. every input plane of a slab is extended by ``w`` rows per side from its
   mesh neighbours; the slabs at the mesh edges get zero rows, which are the
   zero-padded shifts of the global box (aC = 0 rows stay inert);
2. the kernel runs on the extended slab. Each chained colour update uses up
   one row of halo validity per side, the residual one more; ``w`` is that
   total rounded up to even, so the slab's checkerboard parity is the global
   one (slabs are even by ``dist_poisson.make_plan``);
3. ``w`` rows are cropped per side: what is left is the global phase's rows
   of this slab, bit for bit.

Replaces the TPU kernel ``fluidsolver_tpu/parallel/pallas_shard.py:56``
(``fused_smooth_local``). On CPU tensors each slab runs the kernel's twin
``cuda_vcycle.fused_smooth_twin``; on CUDA tensors the kernel, and each
launch also counts as ``fused_smooth_local``.
"""

from __future__ import annotations

from typing import Callable, Optional

from fluidsolver_tpu_torch.parallel import mesh as mesh_mod
from fluidsolver_tpu_torch.parallel.dist_poisson import _extend_op, _split_op
from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
from fluidsolver_tpu_torch.poisson import _kernels, cuda_vcycle


def halo_width(colors, residual: bool) -> int:
    """Rows of halo validity a phase uses per side, rounded up to even."""
    w = len(colors) + (1 if residual else 0)
    return w + (w % 2)


def fused_smooth_local(mesh: SlabMesh, op_loc: list, b_loc: list, x0_loc: Optional[list] = None,
                       colors=(), residual: bool = False, op_ext: Optional[list] = None):
    """One fused smoothing phase on every slab: the half-steps ``colors``
    from ``x0_loc`` (or zero), and with ``residual`` also r = b - A x.
    ``op_loc``, ``b_loc``, ``x0_loc``: per-slab operators and planes;
    ``op_ext``: the slab operators already extended by this phase's
    ``halo_width`` (extended here if None). Returns the slabs of x (and of
    r), cropped back to the slab rows."""
    w = halo_width(colors, residual)
    if op_ext is None:
        op_ext = _extend_op(mesh, op_loc, w)
    b_ext = mesh_mod.extend_x(mesh, b_loc, w)
    x_ext = [None] * len(b_ext) if x0_loc is None else mesh_mod.extend_x(mesh, x0_loc, w)
    xs, rs = [], []
    for o, b, x0 in zip(op_ext, b_ext, x_ext):
        if _kernels.on_cpu(b):
            out = cuda_vcycle.fused_smooth_twin(o, b, x0=x0, colors=tuple(colors), residual=residual)
        else:
            with mesh_mod.current(b.device):
                out = cuda_vcycle.fused_smooth_cuda(o, b, x0=x0, colors=tuple(colors),
                                                    residual=residual)
            _kernels.launches["fused_smooth_local"] += 1
        x, r = out if residual else (out, None)
        xs.append(x[w:-w])
        if residual:
            rs.append(r[w:-w])
    return (xs, rs) if residual else xs


def make_sharded_smoother(mesh: SlabMesh, colors, residual: bool = False) -> Callable:
    """``smooth(op, b, x0) -> x`` (or ``(x, r)``) on global planes: the
    planes are cut into ``len(mesh)`` slabs, each slab runs
    :func:`fused_smooth_local`, and the slabs are gathered onto
    ``devices[0]``. The row count must divide into even slabs."""
    n = len(mesh)

    def smooth(op, b, x0=None):
        N = b.shape[0]
        if N % (2 * n):
            raise ValueError(f"{N} rows do not divide into {n} even slabs")
        rows = N // n
        split = lambda a: mesh_mod.scatter_rows(mesh, a, rows)  # noqa: E731
        out = fused_smooth_local(mesh, _split_op(mesh, op, rows), split(b),
                                 None if x0 is None else split(x0), colors, residual)
        if residual:
            return mesh_mod.all_gather_rows(mesh, out[0]), mesh_mod.all_gather_rows(mesh, out[1])
        return mesh_mod.all_gather_rows(mesh, out)

    return smooth
