"""Kernel 12, ``overlap``: the overlap accumulation of the sparse VOF
advection in one launch.

Per active lane: the start polygon (the flux-corrected octagon, or the
plain backtraced quad of the ``no_correction`` variant) is clipped
against each of the 9 neighbour cells (W, E, S, N edges) and the
neighbour's PLIC liquid half-plane; the areas of the neighbours whose
fraction exceeds the mixed-cell cutoff are summed. Returns (overlap,
start polygon area), both (m,).

CUDA source: ``csrc/overlap.cu`` (per block of lanes, a shared list of
the (lane, neighbour) pairs above the cutoff, one thread a listed pair's
clip chain with the polygon in shared memory, one thread a lane's sum;
the other pairs run no clip; ``fs_overlap`` takes octagons,
``fs_overlap_quad`` quads); replaces the TPU kernel
``fluidsolver_tpu/vof/pallas_advect.py:157``. The plain PyTorch twin
gathers the (5, 9, m) neighbourhood and runs the fixed-K clip chain of
``advect.overlap_from_neighbors``; it sums the shoelace terms and the 9
neighbours in another order, so the two agree to rounding.
"""

from __future__ import annotations

import torch

from fluidsolver_tpu_torch.constants import vf_cutoffs
from fluidsolver_tpu_torch.poisson import _kernels
from fluidsolver_tpu_torch.vof.advect import overlap_from_neighbors, pad_slots, poly_area
from fluidsolver_tpu_torch.vof.plic import NEIGHBOR_OFFSETS, Plic

# start-polygon slots -> the kernel's entry point: the octagon, the quad
ENTRY = {8: "fs_overlap", 4: "fs_overlap_quad"}


def gather_neighbourhood(vf, rec: Plic, iig, jjg):
    """(5, 9, m) lane data [vf, valid (0/1), plic nx, ny, d] of each lane's
    3x3 neighbourhood (interior lane indices, already clamped)."""
    offs = torch.tensor(NEIGHBOR_OFFSETS, dtype=torch.int64, device=vf.device)
    II = 1 + offs[:, 0:1] + iig[None, :]
    JJ = 1 + offs[:, 1:2] + jjg[None, :]
    stacked = torch.stack([vf, rec.valid.to(vf.dtype), rec.nx, rec.ny, rec.d])
    return stacked[:, II, JJ]


def overlap_twin(slots_x, slots_y, vf, rec: Plic, iig, jjg, dx: float, dy: float):
    """The plain PyTorch version."""
    vx, vy, n = pad_slots(slots_x, slots_y)
    gathered = gather_neighbourhood(vf, rec, iig, jjg)
    return overlap_from_neighbors(vx, vy, n, gathered, dx, dy), poly_area(vx, vy, n)


def overlap_cuda(slots_x, slots_y, vf, rec: Plic, iig, jjg, dx: float, dy: float):
    """Launch the kernel; the two outputs are views of one (2, m) buffer.
    Every launch counts as ``overlap``; a quad's also as ``overlap_n0_4``."""
    _kernels.check([slots_x, slots_y, vf, rec.nx, rec.ny, rec.d], vf.device, vf.dtype)
    _kernels.check([iig, jjg], vf.device, torch.int64)
    _kernels.check([rec.valid], vf.device, torch.bool)
    n0, m = slots_x.shape
    N, M = vf.shape
    if n0 not in ENTRY or slots_y.shape != (n0, m) or iig.shape != (m,) or jjg.shape != (m,):
        raise ValueError(f"expected (8, m) or (4, m) slot planes and (m,) lane indices; got "
                         f"{tuple(slots_x.shape)}, {tuple(iig.shape)}")
    if any(t.shape != (N, M) for t in (rec.nx, rec.ny, rec.d, rec.valid)):
        raise ValueError("vf and the PLIC planes must share one shape")
    out = torch.empty((2, m), dtype=vf.dtype, device=vf.device)
    lo, _ = vf_cutoffs(vf.dtype)
    rc = getattr(_kernels.lib(), ENTRY[n0])(
        _kernels.dtype_code(vf.dtype), slots_x.data_ptr(), slots_y.data_ptr(), iig.data_ptr(),
        jjg.data_ptr(), vf.data_ptr(), rec.valid.data_ptr(), rec.nx.data_ptr(), rec.ny.data_ptr(),
        rec.d.data_ptr(), N, M, m, float(dx), float(dy), lo, out[0].data_ptr(),
        out[1].data_ptr(), _kernels.stream(vf.device))
    _kernels.raise_on_error(rc, "overlap")
    if n0 == 4:
        _kernels.launches["overlap_n0_4"] += 1
    return out[0], out[1]


def overlap(slots_x, slots_y, vf, rec: Plic, iig, jjg, dx: float, dy: float):
    """Dispatch: the kernel for CUDA tensors, the twin for CPU tensors.
    ``slots_x``/``slots_y``: (8, m) cell-local octagon vertices or (4, m)
    quad corners; ``iig``,
    ``jjg``: (m,) clamped interior lane indices."""
    impl = overlap_twin if _kernels.on_cpu(vf) else overlap_cuda
    return impl(slots_x, slots_y, vf, rec, iig, jjg, dx, dy)
