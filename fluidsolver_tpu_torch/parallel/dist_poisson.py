"""Distributed BoxMG-preconditioned CG over the x-slab mesh: port of
``fluidsolver_tpu.parallel.dist_poisson``.

The same BoxMG-PCG as the single-device path (``poisson/boxmg.py`` +
``poisson/cg.py``), run slab by slab over a ``mesh.SlabMesh``:

- **x-slabs.** The (nx+2, ny+2) box is padded with decoupled identity rows
  (aC = 1, couplings 0, rhs 0) up to ``NX`` rows, divisible by
  ``ndev * 2^L``; slab ``i`` holds rows ``[i mx, (i+1) mx)``. The padding
  rows solve to 0 and never couple back.
- **The setup on halo-extended slabs.** Per distributed level each slab's
  operator is extended by 2 rows from its neighbours (zeros beyond the mesh
  edge: the global code's zero-padded shifts) and set up by the port's
  ``cuda_rap.fused_rap`` (kernel #4 on CUDA tensors; ``collapse_weights`` +
  ``galerkin_closed`` on the CPU), then cropped. Slabs are even, so local
  parity is global parity.
- **Distributed fine levels, gathered tail.** Each smoothing phase is one
  ``cuda_shard.fused_smooth_local`` (kernel #1 on the halo-extended slab);
  restriction and prolongation run on extended slabs through
  ``boxmg.restrict_box`` / ``prolong_box``. Below ``L_dist`` levels the
  coarse level is gathered onto ``devices[0]``, cropped to its real rows,
  and the rest of the hierarchy is the stock ``boxmg.build_hierarchy`` /
  ``v_cycle`` there (on CUDA: kernels #1-#3 in f32; in f64 #1 and #4 down
  to the dense coarsest inverse, as the JAX package's CPU path).
- **PCG with summed dots.** The recurrence of ``cg.solve_pcg`` and its
  guards (``cg.Guards``: stagnation window, breakdown guard, best iterate),
  every dot product a ``mesh.psum``; the projection masks the padding rows,
  so the singular (all-Neumann) case subtracts the mean over the real
  cells. One counted host read per iteration (``core.sync``), as ``cg.py``
  makes. The single-device solve runs its recurrence as kernels #5-#7;
  here it is plain dots and updates, as in the JAX package's
  ``_pcg_local``, and the warm-start test is made here.

A slab's operator is extended for a smoothing phase once per level and halo
width (:meth:`DistLevel.extended`); a phase extends only b and x0. A
solve extends its operator by one row once, for its products A p.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.parallel import mesh as mesh_mod
from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
from fluidsolver_tpu_torch.poisson import boxmg, cg, cuda_rap
from fluidsolver_tpu_torch.poisson.boxmg import (COEF_NAMES, WEIGHT_NAMES, Stencil9, prolong_box,
                                                 red_mask, restrict_box)
from fluidsolver_tpu_torch.poisson.linsys import StencilOp

_OP5 = COEF_NAMES[:5]
# the most distributed levels a plan takes (the JAX package's max_dist)
MAX_DIST = 4


# ---------------------------------------------------------------- planning
def _global_depth(nx2: int, ny2: int) -> int:
    """Levels ``boxmg.build_hierarchy`` stops at for a (nx2, ny2) box (the
    shared stop predicate ``boxmg._stop_here``)."""
    return boxmg._remaining_depth((nx2, ny2), 0)


@dataclasses.dataclass(frozen=True)
class Plan:
    ndev: int
    NX: int            # padded global rows at level 0
    nx2: int           # real rows at level 0
    ny2: int
    L_dist: int        # distributed levels (the tail is gathered below them)
    n_real: tuple      # real rows per level, 0..L_dist
    ny: tuple          # columns per level, 0..L_dist

    @property
    def mx(self) -> tuple:
        """Slab rows per level, 0..L_dist."""
        return tuple(self.NX // (self.ndev * (1 << l)) for l in range(self.L_dist + 1))


def make_plan(nx2: int, ny2: int, ndev: int) -> Plan:
    if ndev < 2:
        raise ValueError("sharded solve needs >= 2 devices (use cg.solve_pcg)")
    if nx2 < 2 * ndev:
        raise ValueError(f"{nx2} rows over {ndev} devices: slabs too thin")
    depth = _global_depth(nx2, ny2)
    # distributed slabs stay even (parity, coarse alignment) and >= 4 rows;
    # the tail needs at least one level of its own
    l_by_size = 0
    while (nx2 >> (l_by_size + 1)) // ndev >= 4:
        l_by_size += 1
    L = max(1, min(depth - 1, MAX_DIST, l_by_size))
    g = ndev * (1 << L)
    NX = -(-nx2 // g) * g
    n_real, ny = [nx2], [ny2]
    for _ in range(L):
        n_real.append((n_real[-1] + 1) // 2)
        ny.append((ny[-1] + 1) // 2)
    return Plan(ndev=ndev, NX=NX, nx2=nx2, ny2=ny2, L_dist=L, n_real=tuple(n_real), ny=tuple(ny))


# ----------------------------------------------------- local-view helpers
_extend_x = mesh_mod.extend_x


def _names(op) -> tuple:
    return COEF_NAMES if isinstance(op, Stencil9) else _OP5


def _extend_op(mesh: SlabMesh, ops: list, w: int) -> list:
    names = _names(ops[0])
    planes = {k: _extend_x(mesh, [getattr(o, k) for o in ops], w) for k in names}
    return [type(ops[0])(**{k: planes[k][i] for k in names}) for i in range(len(ops))]


def _extend_tr(mesh: SlabMesh, trs: list, w: int) -> list:
    planes = {k: _extend_x(mesh, [getattr(t, k) for t in trs], w) for k in WEIGHT_NAMES}
    return [boxmg.BoxTransfer(**{k: planes[k][i] for k in WEIGHT_NAMES}) for i in range(len(trs))]


def _split_op(mesh: SlabMesh, op, rows: int) -> list:
    """A global operator cut into per-slab operators of ``rows`` rows."""
    names = _names(op)
    planes = {k: mesh_mod.scatter_rows(mesh, getattr(op, k), rows) for k in names}
    return [type(op)(**{k: planes[k][i] for k in names}) for i in range(len(mesh))]


def _apply_local(mesh: SlabMesh, ops_ext: list, xs: list) -> list:
    """y = A x slab by slab: ``ops_ext`` are the slab operators extended by
    one row a side (``_extend_op(mesh, ops, 1)``), x gets a one-row halo
    exchange for the x-shifts, and the product's extra rows are cropped."""
    return [boxmg.apply_any(o, e)[1:-1] for o, e in zip(ops_ext, _extend_x(mesh, xs, 1))]


def _sweep_local(mesh: SlabMesh, ops: list, xs: list, bs: list, reverse: bool = False) -> list:
    """A red-black sweep (``boxmg._rb_sweep``) with a halo refresh per
    colour; black first when ``reverse``."""
    ops_ext = _extend_op(mesh, ops, 1)
    for red in ((False, True) if reverse else (True, False)):
        ax = _apply_local(mesh, ops_ext, xs)
        out = []
        for o, x, b, a in zip(ops, xs, bs, ax):
            mask = red_mask(x.shape, x.device)
            x_new = (b - (a - o.aC * x)) / boxmg._safe(o.aC)
            out.append(torch.where(mask if red else ~mask, x_new, x))
        xs = out
    return xs


# ------------------------------------------------------------- the solver
@dataclasses.dataclass
class DistLevel:
    """One distributed level: the per-slab operator and the transfer
    weights of each 2-row extended slab (coarse-shaped), with the slab
    operators extended by each smoothing phase's halo, made on first use."""

    op: list
    tr_ext: list
    _ext: dict = dataclasses.field(default_factory=dict)

    def extended(self, mesh: SlabMesh, w: int) -> list:
        if w not in self._ext:
            self._ext[w] = _extend_op(mesh, self.op, w)
        return self._ext[w]


def _pad_operator(op, b, x0, NX: int):
    """Pad the operator (5- or 9-point) with decoupled identity rows (aC =
    1, couplings 0), and b and x0 with zero rows, up to NX global rows."""
    pad = NX - b.shape[0]
    if pad == 0:
        return op, b, x0

    def padz(a, value=0.0):
        return None if a is None else F.pad(a, (0, 0, 0, pad), value=value)

    op = type(op)(**{k: padz(getattr(op, k), 1.0 if k == "aC" else 0.0) for k in _names(op)})
    return op, padz(b), padz(x0)


def _rap_on(op):
    with mesh_mod.current(op.aC.device):
        return cuda_rap.fused_rap(op)


def _build_dist_levels(mesh: SlabMesh, ops: list, plan: Plan):
    """The distributed hierarchy: per level the slab operators and the
    extended slabs' transfers; then the coarsest distributed product,
    gathered and cropped to its real rows, through the stock build."""
    levels = []
    cur = ops
    for _ in range(plan.L_dist):
        trs, coarse = zip(*(_rap_on(o) for o in _extend_op(mesh, cur, 2)))
        levels.append(DistLevel(op=cur, tr_ext=list(trs)))
        cur = [Stencil9(**{k: getattr(c, k)[1:-1] for k in COEF_NAMES}) for c in coarse]
    rows = plan.n_real[plan.L_dist]
    gathered = Stencil9(**{k: mesh_mod.all_gather_rows(mesh, [getattr(c, k) for c in cur])[:rows]
                           for k in COEF_NAMES})
    return levels, boxmg.build_hierarchy(gathered)


def _dist_v_cycle(mesh: SlabMesh, levels: list, tail: list, plan: Plan, b_loc: list,
                  n_pre: int, n_post: int) -> list:
    from fluidsolver_tpu_torch.parallel import cuda_shard

    pre, post = (True, False) * n_pre, (False, True) * n_post
    w_pre, w_post = cuda_shard.halo_width(pre, True), cuda_shard.halo_width(post, False)

    def cycle(lvl, b_l):
        if lvl == plan.L_dist:
            b_glob = mesh_mod.all_gather_rows(mesh, b_l)
            e = boxmg.v_cycle(tail, b_glob[:plan.n_real[lvl]], n_pre=n_pre, n_post=n_post)
            e = F.pad(e, (0, 0, 0, b_glob.shape[0] - e.shape[0]))
            return mesh_mod.scatter_rows(mesh, e, plan.mx[lvl])
        L = levels[lvl]
        # one kernel launch and one halo extension per smoothing phase
        x, r = cuda_shard.fused_smooth_local(mesh, L.op, b_l, colors=pre, residual=True,
                                             op_ext=L.extended(mesh, w_pre))
        r_ext = _extend_x(mesh, r, 2)
        ec = cycle(lvl + 1, [restrict_box(t, re)[1:-1] for t, re in zip(L.tr_ext, r_ext)])
        ec_ext = _extend_x(mesh, ec, 1)
        x = [xi + prolong_box(t, e, (b.shape[0] + 4, b.shape[1]))[2:-2]
             for xi, t, e, b in zip(x, L.tr_ext, ec_ext, b_l)]
        return cuda_shard.fused_smooth_local(mesh, L.op, b_l, x0_loc=x, colors=post,
                                             op_ext=L.extended(mesh, w_post))

    return cycle(0, b_loc)


def _pcg_local(mesh: SlabMesh, plan: Plan, max_iter: int, singular: bool, n_pre: int,
               n_post: int, ops: list, levels: list, tail: list, b: list, x0: Optional[list],
               tol: float):
    """PCG on the slabs: ``cg.solve_pcg``'s recurrence and guards with
    summed dots. Returns (slabs of x, rel, iterations)."""
    dtype = b[0].dtype
    mx0 = plan.mx[0]
    maskf = [(torch.arange(mx0, device=d)[:, None] + i * mx0 < plan.nx2).to(dtype)
             for i, d in enumerate(mesh.devices)]
    n_cells = plan.nx2 * plan.ny2
    ops_ext = _extend_op(mesh, ops, 1)

    def on(s):
        return mesh_mod.broadcast(mesh, s)

    def pdot(u, v):
        return mesh_mod.psum(mesh, [torch.sum(a * c) for a, c in zip(u, v)])

    def project(v):
        if singular:
            mean = on(mesh_mod.psum(mesh, [torch.sum(a * m) for a, m in zip(v, maskf)]) / n_cells)
            return [(a - s) * m for a, s, m in zip(v, mean, maskf)]
        return [a * m for a, m in zip(v, maskf)]  # padding rows are decoupled; keep them 0

    def M_inv(r):
        z = _dist_v_cycle(mesh, levels, tail, plan, r, n_pre, n_post)
        return [torch.nan_to_num(a, nan=0.0, posinf=0.0, neginf=0.0) for a in z]

    def select(ok, new, old):
        return [torch.where(k, a, c) for k, a, c in zip(on(ok), new, old)]

    b = project(b)
    bb = pdot(b, b)
    b_norm = torch.sqrt(bb)
    safe_b_norm = torch.where(b_norm > 0.0, b_norm, torch.ones_like(b_norm))
    if x0 is None:
        x, r = [torch.zeros_like(a) for a in b], b
    else:
        # the warm start is kept only if it lowers the residual below ||b||
        x0 = project(x0)
        r_ws = [bi - a for bi, a in zip(b, _apply_local(mesh, ops_ext, x0))]
        good = pdot(r_ws, r_ws) < bb
        x = select(good, x0, [torch.zeros_like(a) for a in b])
        r = select(good, r_ws, b)
    p = project(M_inv(r))
    rz = pdot(r, p)
    guards = cg.Guards(torch.sqrt(pdot(r, r)) / safe_b_norm, b_norm, x, select)

    k = 0
    while k < max_iter and guards.running(tol):
        Ap = _apply_local(mesh, ops_ext, p)
        pAp = pdot(p, Ap)
        alpha = on(rz / torch.where(pAp != 0.0, pAp, torch.ones_like(pAp)))
        x_new = [a + s * q for a, s, q in zip(x, alpha, p)]
        r_new = [a - s * q for a, s, q in zip(r, alpha, Ap)]
        z = project(M_inv(r_new))
        rz_new = pdot(r_new, z)
        beta = on(rz_new / torch.where(rz != 0.0, rz, torch.ones_like(rz)))
        p_new = [a + s * q for a, s, q in zip(z, beta, p)]
        x, r, p, rz = guards.accept(pAp, torch.sqrt(pdot(r_new, r_new)) / safe_b_norm, rz_new,
                                    (x_new, r_new, p_new), (x, r, p), rz)
        k += 1
    return (project(guards.x_best) if singular else guards.x_best), guards.best, k


def build_hierarchy_sharded(mesh: SlabMesh, op: StencilOp):
    """The distributed BoxMG hierarchy of a global operator, built once for
    ``solve_pcg_sharded(levels=...)`` (``pressure_precond_refresh="step"``:
    one build a step, reused by the subiterations' solves). Returns the
    opaque pair (distributed levels, gathered tail)."""
    plan = make_plan(op.aC.shape[0], op.aC.shape[1], len(mesh))
    op, _, _ = _pad_operator(op, op.aC, None, plan.NX)
    return _build_dist_levels(mesh, _split_op(mesh, op, plan.mx[0]), plan)


def solve_pcg_sharded(mesh: SlabMesh, op: StencilOp, b: torch.Tensor, *, tol: float,
                      max_iter: int, singular: bool, n_pre: int = 1, n_post: int = 1,
                      x0: Optional[torch.Tensor] = None, levels=None):
    """Global-view entry: shard, solve, gather. Returns (x, rel_residual,
    iterations) as ``cg.solve_pcg`` does, x on ``mesh.devices[0]``.

    ``op``, ``b`` and ``x0`` are global (nx+2, ny+2) planes on
    ``devices[0]``. The hierarchy is built here unless the pair ``levels``
    from :func:`build_hierarchy_sharded` is given."""
    plan = make_plan(b.shape[0], b.shape[1], len(mesh))
    op, b, x0 = _pad_operator(op, b, None if x0 is None else x0.to(b.dtype), plan.NX)
    ops = _split_op(mesh, op, plan.mx[0])
    if levels is None:
        levels = _build_dist_levels(mesh, ops, plan)
    lv, tail = levels
    split = lambda a: mesh_mod.scatter_rows(mesh, a, plan.mx[0])  # noqa: E731
    x, rel, iters = _pcg_local(mesh, plan, int(max_iter), bool(singular), int(n_pre), int(n_post),
                               ops, lv, tail, split(b), None if x0 is None else split(x0), tol)
    return mesh_mod.all_gather_rows(mesh, x)[:plan.nx2], rel, iters
