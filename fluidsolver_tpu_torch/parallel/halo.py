"""Explicit halo exchange over the x-slab mesh: port of
``fluidsolver_tpu.parallel.halo``.

The ghost ring of each slab is refreshed point-to-point from its mesh
neighbours (``mesh.halo_exchange_x``, the JAX package's ``lax.ppermute``),
and scalars are reduced over the slabs (``psum_scalar``, ``pmax_scalar``).
``make_distributed_jacobi_poisson`` is the JAX package's teaching skeleton
of that communication pattern: a halo exchange per sweep and a summed
residual norm. Nothing in the package calls it; ``dist_poisson`` makes its
own exchanges (``mesh.extend_x``).
"""

from __future__ import annotations

from typing import Callable

import torch

from fluidsolver_tpu_torch.parallel import mesh as mesh_mod
from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
from fluidsolver_tpu_torch.poisson.linsys import shift

halo_exchange_x = mesh_mod.halo_exchange_x


def psum_scalar(mesh: SlabMesh, values: list) -> torch.Tensor:
    return mesh_mod.psum(mesh, values)


def pmax_scalar(mesh: SlabMesh, values: list) -> torch.Tensor:
    return mesh_mod.pmax(mesh, values)


def _residual(aC, aL, aR, aB, aT, b, x):
    ax = aC * x + aL * shift(x, -1, 0) + aR * shift(x, 1, 0) + aB * shift(x, 0, -1) + aT * shift(x, 0, 1)
    return b - ax


def make_distributed_jacobi_poisson(mesh: SlabMesh, nx_local: int, ny: int,
                                    n_iter: int = 200) -> Callable:
    """Weighted-Jacobi (0.8) pressure solve over the x-slabs.

    ``solve(aC, aL, aR, aB, aT, b, x0) -> (x, residual norm)`` takes and
    returns global planes that stack ``len(mesh)`` slabs of
    (nx_local + 2, ny + 2), each with its own ghost rows; the 5-point
    coefficients are cut the same way. Each sweep refreshes the ghost rows
    and updates the slab interiors; the residual norm sums the interiors
    over the mesh. No host read."""
    rows = nx_local + 2

    def solve(aC, aL, aR, aB, aT, b, x0):
        planes = [mesh_mod.scatter_rows(mesh, a, rows) for a in (aC, aL, aR, aB, aT, b, x0)]
        aC, aL, aR, aB, aT, b, x = planes
        aC_safe = [torch.where(c == 0.0, torch.ones_like(c), c) for c in aC]
        for _ in range(n_iter):
            x = mesh_mod.halo_exchange_x(mesh, x)
            out = []
            for i in range(len(mesh)):
                r = _residual(aC[i], aL[i], aR[i], aB[i], aT[i], b[i], x[i])
                upd = x[i] + 0.8 * r / aC_safe[i]
                # the interior only; the ghosts are refreshed by the next sweep
                out.append(torch.cat([x[i][:1], upd[1:-1], x[i][-1:]]))
            x = out
        x = mesh_mod.halo_exchange_x(mesh, x)
        sq = [torch.sum(_residual(aC[i], aL[i], aR[i], aB[i], aT[i], b[i], x[i])[1:-1] ** 2)
              for i in range(len(mesh))]
        return mesh_mod.all_gather_rows(mesh, x), torch.sqrt(mesh_mod.psum(mesh, sq))

    return solve
