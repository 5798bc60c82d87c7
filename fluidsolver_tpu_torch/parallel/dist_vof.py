"""Sharded sparse VOF advection: port of ``fluidsolver_tpu.parallel.dist_vof``.

1. Every field is row-padded to ``ndev`` slabs of a common row count ``r``
   (the U array, nx+3 rows, is the tallest), one global row window a slab.
2. Each slab is extended by ``HALO`` rows per side from its neighbours
   (zeros beyond the mesh edge, which owned-cell arithmetic never reaches).
3. The port's sparse advection (``vof.advect.advect``) runs on the extended
   slab with the shard's lane budget and a :class:`ShardView`: the lanes are
   compacted from the slab's owned cells only, coordinates use global rows,
   and the RK4 backtrace samples with the global domain clamp. On CUDA
   tensors each shard's lanes go through kernel #12 ``overlap``.
4. Each slab returns its own rows; the volume error is the largest over the
   shards (``mesh.pmax``). A lane overflow stays a loud ``inf``.

Halo width: the classification and the 3x3 gathers need one row; the
CFL-bounded backtrace (dt |u| <= cfl dx < dx) reads bilinear corners within
two rows; ``HALO = 4`` covers both. Against the single-device sparse path
the differences are rounding: the shifted sampler origin can move a
cell-boundary ``floor`` by one ulp, where the bilinear form is continuous.
"""

from __future__ import annotations

import dataclasses

import torch.nn.functional as F

from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.parallel import mesh as mesh_mod
from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
from fluidsolver_tpu_torch.vof import advect as adv
from fluidsolver_tpu_torch.vof.plic import Plic

HALO = 4


@dataclasses.dataclass(frozen=True)
class ShardView:
    """A shard's view for ``vof.advect.advect``: local row 0 is global
    padded row ``row_off``; the shard owns the global interior cells
    [own_lo, own_hi) (clipped to the grid there)."""

    row_off: int
    own_lo: int
    own_hi: int


def plan_rows(grid: Grid, U_rows: int, ndev: int) -> tuple:
    """(r, R_tot): the common slab row count over every field layout and
    the padded total."""
    r = -(-U_rows // ndev)
    return r, r * ndev


def available(grid: Grid, ndev: int) -> bool:
    """The scheme needs the halo to fit inside one slab's rows."""
    r, _ = plan_rows(grid, grid.nx + 3, ndev)
    return r > HALO + 1


def _advect_local(mesh: SlabMesh, grid: Grid, m_shard: int, r: int, no_correction: bool,
                  planes: list, dt) -> tuple:
    """Every shard's advection; ``planes``: the slabs of vf, the PLIC nx,
    ny, d and valid, U, V, Ui and Vi. Returns (the slabs of vf, the volume
    error of each shard)."""
    ext = [mesh_mod.extend_x(mesh, slabs, HALO) for slabs in planes]
    dts = mesh_mod.broadcast(mesh, dt)
    vf_out, errs = [], []
    for s in range(len(mesh)):
        vf_e, pnx, pny, pd, valid, U, V, Ui, Vi = (e[s] for e in ext)
        rec = Plic(nx=pnx, ny=pny, d=pd, valid=valid, overflow=None)
        shard = ShardView(row_off=s * r - HALO, own_lo=s * r - 1, own_hi=(s + 1) * r - 1)
        with mesh_mod.current(mesh.devices[s]):
            vf, err = adv.advect(vf_e, rec, U, V, Ui, Vi, grid, dts[s], max_active=m_shard,
                                 no_correction=no_correction, shard=shard)
        vf_out.append(vf[HALO:HALO + r])
        errs.append(err)
    return vf_out, errs


def advect_sharded(mesh: SlabMesh, vf_old, rec: Plic, U, V, Ui, Vi, grid: Grid, dt,
                   m_total: int, no_correction: bool = False):
    """Global-view entry: one unsplit sparse advection over the mesh. The
    contract of ``vof.advect.advect`` (returns (vf_new, max volume error),
    ghost values kept), the fields and the result on ``devices[0]``.
    ``m_total`` is the global lane budget, split evenly over the shards: an
    interface crowding into one slab overflows that shard's budget loudly
    (inf), as the single-device budget does."""
    ndev = len(mesh)
    r, R_tot = plan_rows(grid, U.shape[0], ndev)
    m_shard = -(-int(m_total) // ndev)
    planes = [mesh_mod.scatter_rows(mesh, F.pad(a, (0, 0, 0, R_tot - a.shape[0])), r)
              for a in (vf_old, rec.nx, rec.ny, rec.d, rec.valid, U, V, Ui, Vi)]
    vf_out, errs = _advect_local(mesh, grid, m_shard, r, bool(no_correction), planes, dt)
    return mesh_mod.all_gather_rows(mesh, vf_out)[:vf_old.shape[0]], mesh_mod.pmax(mesh, errs)
