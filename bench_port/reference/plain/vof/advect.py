"""Unsplit geometric VOF advection: port of ``fluidsolver_tpu.vof.advect``.

The cells whose 3x3 neighbourhood is neither all gas nor all liquid are
compacted, in row-major order, into ``max_active`` lanes. Per lane the 4
cell corners are RK4-backtracked through the clamped-bilinear cell-centered
velocity; each face gets a midpoint vertex displaced so that the face's
swept area equals the staggered flux ``U_face * dy * dt``; the octagon so
formed is clipped against each of the 9 neighbour cells and the
neighbour's PLIC liquid half-plane (``overlap_lanes``, the port's kernel #12),
and the new fraction is the summed overlap over the octagon's area. The
other cells take 0 or 1 (all gas / all liquid); ghost fractions are kept.

Everything stays on the device: the compaction is ``nonzero_static``
(no host read, unlike ``nonzero``), fill lanes gather through clamped
indices and scatter into a scratch slot, and an active set larger than
the budget comes out as an infinite volume error.

``max_active=0`` runs the dense all-cells path instead, the oracle of the
sparse one: the same per-cell arithmetic on every interior cell in plain
PyTorch (the JAX package's dense path reaches no TPU kernel either). Two
A/B variants of the reference's compile-time switches change only the
start polygon and the backtrace, on either path: ``no_correction``
(VOF_NO_CORRECTION: the plain backtraced quadrilateral, no flux-matched
face caps; on the sparse path its four slots go to kernel #12 as they
are) and ``staggered`` (FS_VOF_ADVECT_WITH_STAGGERED_VELOCITY: RK4
through the raw staggered velocity).
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F

from bench_port.reference.plain.constants import vf_cutoffs
from bench_port.reference.plain.core.fields import set_interior
from bench_port.reference.plain.core.grid import Grid
from bench_port.reference.plain.ops.stencil import sample_centered, sample_centered_stack
from bench_port.reference.plain.vof.plic import NEIGHBOR_OFFSETS, Plic, shift

K = 16  # vertex buffer size of the plain clip chain


# ---- point backtracking -------------------------------------------------------
def backtrack_rk4(px, py, Ui, Vi, grid: Grid, dt, shard=None):
    """RK4 backward trace through the cell-centered interpolated velocity.

    ``shard``: a slab's view (``parallel/dist_vof.ShardView``): Ui and Vi
    are halo-extended x-slabs, sampled from the slab's shifted origin with
    the global domain clamp (``stencil.sample_centered_stack(x_clamp=)``)."""
    x0 = float(grid.xm[1])
    y0 = float(grid.ym[1])
    x_clamp = None
    if shard is not None:
        x_clamp = (x0, grid.nx, -shard.row_off)
        x0 = x0 + shard.row_off * grid.dx
    UiVi = torch.stack([Ui, Vi])

    def vel(x, y):
        uv = sample_centered_stack(UiVi, x0, grid.dx, y0, grid.dy, x, y, x_clamp=x_clamp)
        return uv[0], uv[1]

    u1, v1 = vel(px, py)
    u2, v2 = vel(px - 0.5 * dt * u1, py - 0.5 * dt * v1)
    u3, v3 = vel(px - 0.5 * dt * u2, py - 0.5 * dt * v2)
    u4, v4 = vel(px - dt * u3, py - dt * v3)
    return (
        px - dt / 6.0 * (u1 + 2.0 * u2 + 2.0 * u3 + u4),
        py - dt / 6.0 * (v1 + 2.0 * v2 + 2.0 * v3 + v4),
    )


def backtrack_rk4_staggered(px, py, U, V, grid: Grid, dt):
    """RK4 backward trace through the raw staggered velocity (the reference's
    ``advect_point2``): u bilinear on the (x-face, y-centre) lattice, v on
    the (x-centre, y-face) lattice, the stage displacements shared."""
    xf0, yc0 = float(grid.x[1]), float(grid.ym[1])
    xc0, yf0 = float(grid.xm[1]), float(grid.y[1])

    def vel(x, y):
        return (sample_centered(U, xf0, grid.dx, yc0, grid.dy, x, y),
                sample_centered(V, xc0, grid.dx, yf0, grid.dy, x, y))

    u1, v1 = vel(px, py)
    u2, v2 = vel(px - 0.5 * dt * u1, py - 0.5 * dt * v1)
    u3, v3 = vel(px - 0.5 * dt * u2, py - 0.5 * dt * v2)
    u4, v4 = vel(px - dt * u3, py - dt * v3)
    return (
        px - dt / 6.0 * (u1 + 2.0 * u2 + 2.0 * u3 + u4),
        py - dt / 6.0 * (v1 + 2.0 * v2 + 2.0 * v3 + v4),
    )


# ---- the start polygon ------------------------------------------------------
def _pentagon_area(p0x, p0y, p1x, p1y, a1x, a1y, mx, my, a0x, a0y):
    """Shoelace of the face-swept pentagon (p0, p1, a1, m, a0)."""
    return 0.5 * (
        p0x * p1y - p1x * p0y
        + p1x * a1y - a1x * p1y
        + a1x * my - mx * a1y
        + mx * a0y - a0x * my
        + a0x * p0y - p0x * a0y
    )


def _face_midpoint(a0x, a0y, a1x, a1y, p0x, p0y, p1x, p1y, target):
    """Cap vertex on face (a1 -> m -> a0): the midpoint of (a0, a1) moved
    perpendicular to the face so that the pentagon's area is ``target``."""
    cx = 0.5 * (a0x + a1x)
    cy = 0.5 * (a0y + a1y)
    quad = _pentagon_area(p0x, p0y, p1x, p1y, a1x, a1y, cx, cy, a0x, a0y)
    ex = a0x - a1x
    ey = a0y - a1y
    elen = torch.sqrt(ex * ex + ey * ey)
    zero = elen == 0.0
    safe = torch.where(zero, torch.ones_like(elen), elen)
    eta = torch.where(elen > 0.0, 2.0 * (target - quad) / safe, torch.zeros_like(elen))
    return cx + eta * ey / safe, cy - eta * ex / safe


def octagon_slots(a00x, a00y, a10x, a10y, a11x, a11y, a01x, a01y,
                  U_W, U_E, V_S, V_N, dx: float, dy: float, dt):
    """The 8 octagon vertices (two lists of per-lane tensors, CCW: corner,
    face midpoint, ...) from the backtracked corners in cell-local
    coordinates and the four face velocities."""
    zeros = torch.zeros_like(a00x)
    dxa = torch.full_like(a00x, dx)
    dya = torch.full_like(a00x, dy)
    mSx, mSy = _face_midpoint(a00x, a00y, a10x, a10y, zeros, zeros, dxa, zeros, -V_S * dx * dt)
    mEx, mEy = _face_midpoint(a10x, a10y, a11x, a11y, dxa, zeros, dxa, dya, U_E * dy * dt)
    mNx, mNy = _face_midpoint(a11x, a11y, a01x, a01y, dxa, dya, zeros, dya, V_N * dx * dt)
    mWx, mWy = _face_midpoint(a01x, a01y, a00x, a00y, zeros, dya, zeros, zeros, -U_W * dy * dt)
    return ([a00x, mSx, a10x, mEx, a11x, mNx, a01x, mWx],
            [a00y, mSy, a10y, mEy, a11y, mNy, a01y, mWy])


def start_slots(ax, ay, U_W, U_E, V_S, V_N, dx: float, dy: float, dt, no_correction: bool):
    """The start polygon's vertices from the backtracked corners ``ax``,
    ``ay`` (sequences in the order p00, p10, p11, p01, cell-local): the
    flux-corrected octagon, or under ``no_correction`` the plain quad of
    the corners, whose area is not reconciled with the face fluxes (an
    O(dt div_h) volume error a step)."""
    if no_correction:
        return list(ax), list(ay)
    corners = [c for xy in zip(ax, ay) for c in xy]
    return octagon_slots(*corners, U_W, U_E, V_S, V_N, dx, dy, dt)


# ---- the plain clip chain (twin of kernel #12) --------------------------------
def _next_vertex(a, n):
    """a[..., (idx + 1) mod n] for the ``n`` valid leading slots."""
    idx = torch.arange(K, device=a.device)
    return torch.where(idx == n[..., None] - 1, a[..., :1], torch.roll(a, -1, dims=-1))


def poly_area(vx, vy, n):
    """Signed shoelace area of (..., K) polygons with ``n`` valid slots."""
    valid = torch.arange(K, device=vx.device) < n[..., None]
    contrib = vx * _next_vertex(vy, n) - _next_vertex(vx, n) * vy
    return 0.5 * torch.sum(torch.where(valid, contrib, torch.zeros_like(contrib)), dim=-1)


def clip_halfplane(vx, vy, n, a, b, c):
    """Sutherland-Hodgman clip of (..., K) polygons against
    {a x + b y <= c}: slot 2k of the candidates is vertex k, slot 2k+1 the
    crossing on edge k; the emitted ones are compacted stably to the front.
    Returns (vx, vy, n); tail slots are zero."""
    valid = torch.arange(K, device=vx.device) < n[..., None]
    d = a[..., None] * vx + b[..., None] * vy - c[..., None]
    inside = (d <= 0.0) & valid
    d_n = _next_vertex(d, n)
    vx_n = _next_vertex(vx, n)
    vy_n = _next_vertex(vy, n)
    inside_n = _next_vertex(inside, n)

    denom = d - d_n
    t = torch.where(torch.abs(denom) > 0.0,
                    d / torch.where(denom == 0.0, torch.ones_like(denom), denom),
                    torch.zeros_like(denom))
    ix = vx + t * (vx_n - vx)
    iy = vy + t * (vy_n - vy)
    emit_i = (inside ^ inside_n) & valid

    out_x = torch.stack([vx, ix], dim=-1).flatten(-2)
    out_y = torch.stack([vy, iy], dim=-1).flatten(-2)
    flags = torch.stack([inside, emit_i], dim=-1).flatten(-2)
    pos = torch.arange(2 * K, device=vx.device)
    keys = torch.where(flags, pos, 2 * K + pos)
    order = torch.argsort(keys, dim=-1)[..., :K]
    out_x = torch.gather(out_x, -1, order)
    out_y = torch.gather(out_y, -1, order)
    new_n = flags.sum(dim=-1).to(n.dtype)
    tail = torch.arange(K, device=vx.device) >= new_n[..., None]
    out_x = torch.where(tail, torch.zeros_like(out_x), out_x)
    out_y = torch.where(tail, torch.zeros_like(out_y), out_y)
    return out_x, out_y, new_n


def pad_slots(slots_x, slots_y):
    """(..., K) buffers of the start polygons (n0 valid leading slots)."""
    n0 = slots_x.shape[0]
    pad = slots_x.new_zeros((K - n0,) + slots_x.shape[1:])
    vx = torch.cat([slots_x, pad]).movedim(0, -1)
    vy = torch.cat([slots_y, pad]).movedim(0, -1)
    n = torch.full(slots_x.shape[1:], n0, dtype=torch.int32, device=slots_x.device)
    return vx, vy, n


def overlap_from_neighbors(vx, vy, n, gathered, dx: float, dy: float):
    """Sum over the 9 neighbours of the area of (start polygon ∩ neighbour
    cell ∩ neighbour liquid half-plane), counted where the neighbour's
    fraction exceeds the mixed-cell cutoff. ``gathered``: (5, 9, m) lane
    data [vf, valid (0/1), plic nx, plic ny, plic d] in NEIGHBOR_OFFSETS
    order; the polygons (m, K) are broadcast over the neighbours. The lane
    axis may be any shape: (nx, ny) on the dense path."""
    vf_nb, mixed = gathered[0], gathered[1] > 0.5
    pnx, pny, pd = gathered[2], gathered[3], gathered[4]
    offs = torch.tensor(NEIGHBOR_OFFSETS, dtype=vx.dtype, device=vx.device)
    lead = (9,) + (1,) * (vf_nb.dim() - 1)
    x_lo = (offs[:, 0] * dx).reshape(lead).expand_as(vf_nb)
    y_lo = (offs[:, 1] * dy).reshape(lead).expand_as(vf_nb)
    ones, zeros = torch.ones_like(x_lo), torch.zeros_like(x_lo)
    vx = vx.expand(9, *vx.shape)
    vy = vy.expand(9, *vy.shape)
    n = n.expand(9, *n.shape)
    vx, vy, n = clip_halfplane(vx, vy, n, -ones, zeros, -x_lo)
    vx, vy, n = clip_halfplane(vx, vy, n, ones, zeros, x_lo + dx)
    vx, vy, n = clip_halfplane(vx, vy, n, zeros, -ones, -y_lo)
    vx, vy, n = clip_halfplane(vx, vy, n, zeros, ones, y_lo + dy)
    a_p = torch.where(mixed, pnx, zeros)
    b_p = torch.where(mixed, pny, zeros)
    c_p = torch.where(mixed, pd + pnx * x_lo + pny * y_lo, ones)
    vx, vy, n = clip_halfplane(vx, vy, n, a_p, b_p, c_p)
    area = poly_area(vx, vy, n)
    lo, _ = vf_cutoffs(vf_nb.dtype)
    return torch.sum(torch.where(vf_nb > lo, area, torch.zeros_like(area)), dim=0)


# ---- classification and lane compaction --------------------------------------
def classify(vf_old):
    """(all_gas, all_liquid) over the interior: the 3x3 neighbourhood sum
    below the low cutoff, or at least 9 times the high one."""
    lo, hi = vf_cutoffs(vf_old.dtype)
    nb_sum = torch.zeros_like(shift(vf_old, 0, 0))
    for di, dj in NEIGHBOR_OFFSETS:
        nb_sum = nb_sum + shift(vf_old, di, dj)
    return nb_sum < lo, nb_sum >= 9.0 * hi


def default_max_active(nx: int, ny: int) -> int:
    """Active-lane budget of the sparse path."""
    return min(nx * ny, max(4096, 16 * max(nx, ny)))


def compact_indices(mask: torch.Tensor, m: int) -> torch.Tensor:
    """Row-major linear indices of the first ``m`` True cells of a 2D mask,
    padded with ``mask.numel()``; the fixed output size needs no host read."""
    return torch.nonzero_static(mask.reshape(-1), size=m, fill_value=mask.numel())[:, 0]


@functools.lru_cache(maxsize=16)
def _corner_coords(grid: Grid, dtype: torch.dtype, device: torch.device):
    """x and y of the interior faces (corner lattice), made once per grid,
    dtype and device so that no step copies from the host."""
    return (torch.as_tensor(grid.x[1:-1], dtype=dtype, device=device),
            torch.as_tensor(grid.y[1:-1], dtype=dtype, device=device))


@dataclasses.dataclass
class Lanes:
    """The active cells of one advection, compacted into ``m`` lanes."""

    lin: torch.Tensor        # (m,) row-major interior index; nx*ny on fill lanes
    is_fill: torch.Tensor    # (m,) bool
    iig: torch.Tensor        # (m,) clamped interior indices, for gathers
    jjg: torch.Tensor
    n_active: torch.Tensor   # 0-d: active cells (may exceed m)
    all_liq: torch.Tensor    # (nx, ny) bool: the all-liquid early exit
    slots_x: torch.Tensor    # (n0, m) start-polygon vertices, cell-local:
    slots_y: torch.Tensor    # n0 = 8 (octagon) or 4 (quad, no_correction)


def _backtrack(px, py, U, V, Ui, Vi, grid: Grid, dt, staggered: bool, shard=None):
    if staggered:
        if shard is not None:
            raise NotImplementedError("the slab view takes the cell-centred backtrace only")
        return backtrack_rk4_staggered(px, py, U, V, grid, dt)
    return backtrack_rk4(px, py, Ui, Vi, grid, dt, shard=shard)


def owned_rows(nx: int, grid: Grid, shard, device) -> torch.Tensor:
    """(nx,) bool: the slab's interior rows that its shard owns (each
    global cell is owned by one shard; halo rows and rows beyond the grid
    are not)."""
    ig = torch.arange(nx, device=device) + shard.row_off
    return (ig >= shard.own_lo) & (ig < shard.own_hi) & (ig >= 0) & (ig < grid.nx)


def prepare_lanes(vf_old, U, V, Ui, Vi, grid: Grid, dt, m: int, no_correction: bool = False,
                  staggered: bool = False, shard=None) -> Lanes:
    """Classify, compact the active cells into ``m`` lanes and build each
    lane's backtracked start polygon. ``shard``: a slab's view (see
    :func:`advect`); the lanes are then the owned rows' active cells."""
    nx, ny = vf_old.shape[0] - 2, vf_old.shape[1] - 2
    all_gas, all_liq = classify(vf_old)
    active = ~(all_gas | all_liq)
    if shard is not None:
        active = active & owned_rows(nx, grid, shard, active.device)[:, None]
    lin = compact_indices(active, m)
    is_fill = lin >= nx * ny
    ii = torch.where(is_fill, nx * ny, lin // ny)
    jj = torch.where(is_fill, nx * ny, lin % ny)
    iig, jjg = torch.clamp_max(ii, nx - 1), torch.clamp_max(jj, ny - 1)

    # per-lane corners, backtracked; then cell-local coordinates
    gx, gy = _corner_coords(grid, vf_old.dtype, vf_old.device)
    # the lanes' global rows (a slab's local rows shifted by its offset)
    ig = iig if shard is None else torch.clamp(iig + shard.row_off, 0, grid.nx - 1)
    x_lo_c, x_hi_c = gx[ig], gx[ig + 1]
    y_lo_c, y_hi_c = gy[jjg], gy[jjg + 1]
    px = torch.stack([x_lo_c, x_hi_c, x_hi_c, x_lo_c], dim=-1)
    py = torch.stack([y_lo_c, y_lo_c, y_hi_c, y_hi_c], dim=-1)
    AX, AY = _backtrack(px, py, U, V, Ui, Vi, grid, dt, staggered, shard)
    ax = AX - x_lo_c[:, None]
    ay = AY - y_lo_c[:, None]
    slots_x, slots_y = start_slots(
        ax.unbind(-1), ay.unbind(-1),
        U[1 + iig, 1 + jjg], U[2 + iig, 1 + jjg], V[1 + iig, 1 + jjg], V[1 + iig, 2 + jjg],
        grid.dx, grid.dy, dt, no_correction)
    return Lanes(lin=lin, is_fill=is_fill, iig=iig, jjg=jjg, n_active=torch.sum(active),
                 all_liq=all_liq, slots_x=torch.stack(slots_x), slots_y=torch.stack(slots_y))


def advect(vf_old, rec: Plic, U, V, Ui, Vi, grid: Grid, dt, max_active=None,
           no_correction: bool = False, staggered: bool = False, shard=None):
    """One unsplit geometric advection of the VOF field. Returns (vf_new,
    max volume error). ``max_active``: the lane budget of the sparse path
    (None = ``default_max_active``); the error is inf when the active set
    outgrows it. 0 runs the dense all-cells path.

    ``shard``: a slab's view of the sparse path (``parallel/dist_vof.py``,
    an object with ``row_off``, ``own_lo`` and ``own_hi``): every array is
    a halo-extended x-slab of the global field whose local row 0 is global
    row ``row_off``; the lanes are compacted from the owned interior cells
    [own_lo, own_hi) only, their corners take global rows, the backtrace
    clamps to the global domain, and the cells the shard does not own keep
    their input values. ``max_active`` is then the shard's budget."""
    if max_active == 0:
        if shard is not None:
            raise ValueError("the slab view is the sparse path's")
        return advect_dense(vf_old, rec, U, V, Ui, Vi, grid, dt, no_correction, staggered)
    nx, ny = vf_old.shape[0] - 2, vf_old.shape[1] - 2
    dx, dy = grid.dx, grid.dy
    m = int(max_active or default_max_active(grid.nx, grid.ny))
    lanes = prepare_lanes(vf_old, U, V, Ui, Vi, grid, dt, m, no_correction, staggered, shard)
    overlap, oct_area = overlap_lanes(lanes.slots_x, lanes.slots_y, vf_old, rec,
                                      lanes.iig, lanes.jjg, dx, dy)
    volume_error = torch.abs(dx * dy - torch.abs(oct_area))
    vf_act = overlap / torch.where(oct_area == 0.0, torch.ones_like(oct_area), oct_area)

    # early exits dense, active lanes scattered (fill lanes into a scratch slot)
    vf_new = torch.cat([lanes.all_liq.to(vf_old.dtype).reshape(-1), vf_old.new_zeros(1)])
    vf_new.scatter_(0, torch.where(lanes.is_fill, nx * ny, lanes.lin), vf_act)
    vf_out = set_interior(vf_old, vf_new[:-1].reshape(nx, ny))
    if shard is not None:
        # the cells of other shards (halo rows, rows beyond the grid) keep
        # their input values: their owners compute them
        owned = F.pad(owned_rows(nx, grid, shard, vf_old.device)[:, None].expand(nx, ny),
                      (1, 1, 1, 1))
        vf_out = torch.where(owned, vf_out, vf_old)

    lane_valid = torch.arange(m, device=vf_old.device) < lanes.n_active
    vol_err = torch.max(torch.where(lane_valid, volume_error, torch.zeros_like(volume_error)))
    vol_err = torch.where(lanes.n_active > m, torch.full_like(vol_err, float("inf")), vol_err)
    return vf_out, vol_err


def advect_dense(vf_old, rec: Plic, U, V, Ui, Vi, grid: Grid, dt, no_correction: bool = False,
                 staggered: bool = False):
    """The all-cells advection: every interior cell's start polygon clipped
    against its 9 neighbours in one batch of plain PyTorch (the clip chain
    holds nine (nx, ny, K) vertex planes at a time). Per cell the same
    arithmetic as the sparse path. Returns (vf_new, max volume error)."""
    dx, dy = grid.dx, grid.dy
    gx, gy = _corner_coords(grid, vf_old.dtype, vf_old.device)
    PX, PY = torch.meshgrid(gx, gy, indexing="ij")
    AX, AY = _backtrack(PX, PY, U, V, Ui, Vi, grid, dt, staggered)
    # corners in cell-local coordinates (origin: the cell's lower-left corner)
    X0, Y0 = PX[:-1, :-1], PY[:-1, :-1]
    ax = [AX[:-1, :-1] - X0, AX[1:, :-1] - X0, AX[1:, 1:] - X0, AX[:-1, 1:] - X0]
    ay = [AY[:-1, :-1] - Y0, AY[1:, :-1] - Y0, AY[1:, 1:] - Y0, AY[:-1, 1:] - Y0]
    slots_x, slots_y = start_slots(ax, ay, U[1:-2, 1:-1], U[2:-1, 1:-1], V[1:-1, 1:-2],
                                   V[1:-1, 2:-1], dx, dy, dt, no_correction)
    vx, vy, n = pad_slots(torch.stack(slots_x), torch.stack(slots_y))
    oct_area = poly_area(vx, vy, n)
    volume_error = torch.abs(dx * dy - torch.abs(oct_area))

    planes = torch.stack([vf_old, rec.valid.to(vf_old.dtype), rec.nx, rec.ny, rec.d])
    N, M = vf_old.shape
    gathered = torch.stack([planes[:, 1 + di: N - 1 + di, 1 + dj: M - 1 + dj]
                            for di, dj in NEIGHBOR_OFFSETS], dim=1)
    overlap = overlap_from_neighbors(vx, vy, n, gathered, dx, dy)
    vf_new = overlap / torch.where(oct_area == 0.0, torch.ones_like(oct_area), oct_area)

    all_gas, all_liq = classify(vf_old)
    early = all_gas | all_liq
    vf_new = torch.where(all_gas, torch.zeros_like(vf_new),
                         torch.where(all_liq, torch.ones_like(vf_new), vf_new))
    volume_error = torch.where(early, torch.zeros_like(volume_error), volume_error)
    return set_interior(vf_old, vf_new), torch.max(volume_error)


def gather_neighbourhood(vf, rec: Plic, iig, jjg):
    """(5, 9, m) lane data [vf, valid (0/1), plic nx, ny, d] of each lane's
    3x3 neighbourhood (interior lane indices, already clamped)."""
    offs = torch.tensor(NEIGHBOR_OFFSETS, dtype=torch.int64, device=vf.device)
    II = 1 + offs[:, 0:1] + iig[None, :]
    JJ = 1 + offs[:, 1:2] + jjg[None, :]
    stacked = torch.stack([vf, rec.valid.to(vf.dtype), rec.nx, rec.ny, rec.d])
    return stacked[:, II, JJ]


def overlap_lanes(slots_x, slots_y, vf, rec: Plic, iig, jjg, dx: float, dy: float):
    """(overlap, start polygon area), both (m,): each lane's start polygon
    (``slots_x``/``slots_y``: (8, m) octagon vertices or (4, m) quad
    corners) clipped against its 9 neighbour cells and their PLIC liquid
    half-planes (the fixed-K chain of ``overlap_from_neighbors``), summed
    over the neighbours above the mixed-cell cutoff; ``iig``, ``jjg``: (m,)
    clamped interior lane indices."""
    vx, vy, n = pad_slots(slots_x, slots_y)
    gathered = gather_neighbourhood(vf, rec, iig, jjg)
    return overlap_from_neighbors(vx, vy, n, gathered, dx, dy), poly_area(vx, vy, n)
