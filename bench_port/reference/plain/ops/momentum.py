"""Momentum transport on the staggered grid: port of
``fluidsolver_tpu.ops.momentum`` (momentum and density transport, the
two-phase property mixing, the capillary pressure jump and the tangent-
force alternative to it).

Conservative flux form with hybrid central/upwind interpolation at density
jumps, the same expressions in the same floating-point order as the JAX
package. Corner-mesh arrays have no ghosts and carry logical (i, j) in
[0, nx+1) x [0, ny+1) directly.

``FS_NAN_POISON=1`` is the reference's scratch-NaN debug mode
(src/FS.hpp:163-171), read where the JAX package reads it: the ghost rings
that ``calc_dmomdt`` and ``calc_drhodt`` synthesize around their interior
results are NaN instead of zero, so a consumer that reads one instead of
BC-filled data trips a NaN. It is the one environment variable the port
reads; a correct run is bitwise the unpoisoned one.
"""

from __future__ import annotations

import math
import os

import torch
import torch.nn.functional as F

from bench_port.reference.plain.constants import vf_cutoffs
from bench_port.reference.plain.core.bc import apply_neumann_scalar
from bench_port.reference.plain.core.fields import add_interior, pad_interior, set_interior


def calc_rho_eps(rho_gas: float, rho_liquid: float) -> float:
    """Density-jump threshold for upwinding."""
    return 1e-3 * min(rho_gas, rho_liquid)


def hybrid_interp(rho_eps, rho_m, rho_p, velo_m, velo_p, transp_m, transp_p):
    """Central average, switching to upwind (by transport velocity sign) when
    the density jump exceeds ``rho_eps``."""
    upwind_minus = transp_p + transp_m >= 0.0
    rho_up = torch.where(upwind_minus, rho_m, rho_p)
    velo_up = torch.where(upwind_minus, velo_m, velo_p)
    use_up = torch.abs(rho_p - rho_m) > rho_eps
    rho = torch.where(use_up, rho_up, 0.5 * (rho_p + rho_m))
    velo = torch.where(use_up, velo_up, 0.5 * (velo_p + velo_m))
    return rho, velo


def _visc_corner(visc: torch.Tensor) -> torch.Tensor:
    """Viscosity averaged to cell corners; corner (i,j) in [0,nx+1)x[0,ny+1)."""
    return 0.25 * (visc[1:, 1:] + visc[:-1, 1:] + visc[1:, :-1] + visc[:-1, :-1])


def _pad1(interior: torch.Tensor) -> torch.Tensor:
    """Embed an interior-sized flux divergence into a synthesized ghost
    ring: zero, or NaN under ``FS_NAN_POISON=1`` (the ring is un-written
    scratch)."""
    fill = math.nan if os.environ.get("FS_NAN_POISON") == "1" else 0.0
    return F.pad(interior, (1, 1, 1, 1), value=fill)


def calc_dmomdt(U, V, rho_u_old, rho_v_old, visc, p, p_jump_u, p_jump_v,
                dx: float, dy: float, rho_eps: float):
    """d(rho u)/dt = -div(rho u u) + div(mu grad u) - grad p + p_jump.

    Returns (dmomUdt, dmomVdt) with synthesized ghost rings (:func:`_pad1`)."""
    # FXU on the center mesh: -rho*U^2 + 2*mu*dUdx - p
    rho_h, u_h = hybrid_interp(
        rho_eps, rho_u_old[:-1, :], rho_u_old[1:, :], U[:-1, :], U[1:, :], U[:-1, :], U[1:, :]
    )
    u_c = 0.5 * (U[1:, :] + U[:-1, :])
    dudx = (U[1:, :] - U[:-1, :]) / dx
    FXU = -rho_h * u_h * u_c + 2.0 * visc * dudx - p

    # FYU on the corner mesh: -rho*U*V + mu*(dUdy + dVdx)
    u_lo = U[1:-1, :-1]
    u_hi = U[1:-1, 1:]
    v_lo = V[:-1, 1:-1]
    v_hi = V[1:, 1:-1]
    mu_c = _visc_corner(visc)
    dudy = (u_hi - u_lo) / dy
    dvdx = (v_hi - v_lo) / dx
    rho_h, u_h = hybrid_interp(
        rho_eps, rho_u_old[1:-1, :-1], rho_u_old[1:-1, 1:], u_lo, u_hi, v_lo, v_hi
    )
    FYU = -rho_h * u_h * 0.5 * (v_lo + v_hi) + mu_c * (dudy + dvdx)

    # FXV on the corner mesh
    rho_h, v_h = hybrid_interp(
        rho_eps, rho_v_old[:-1, 1:-1], rho_v_old[1:, 1:-1], v_lo, v_hi, u_lo, u_hi
    )
    FXV = -rho_h * v_h * 0.5 * (u_lo + u_hi) + mu_c * (dudy + dvdx)

    # FYV on the center mesh
    rho_h, v_h = hybrid_interp(
        rho_eps, rho_v_old[:, :-1], rho_v_old[:, 1:], V[:, :-1], V[:, 1:], V[:, :-1], V[:, 1:]
    )
    v_c = 0.5 * (V[:, 1:] + V[:, :-1])
    dvdy = (V[:, 1:] - V[:, :-1]) / dy
    FYV = -rho_h * v_h * v_c + 2.0 * visc * dvdy - p

    dmomU = _pad1(
        (FXU[1:, 1:-1] - FXU[:-1, 1:-1]) / dx
        + (FYU[:, 1:] - FYU[:, :-1]) / dy
        + p_jump_u[1:-1, 1:-1]
    )
    dmomV = _pad1(
        (FXV[1:, :] - FXV[:-1, :]) / dx
        + (FYV[1:-1, 1:] - FYV[1:-1, :-1]) / dy
        + p_jump_v[1:-1, 1:-1]
    )
    return dmomU, dmomV


def _hybrid_rho(rho_eps, rho_m, rho_p, transp_m, transp_p):
    """The density half of :func:`hybrid_interp`."""
    upwind_minus = transp_p + transp_m >= 0.0
    rho_up = torch.where(upwind_minus, rho_m, rho_p)
    use_up = torch.abs(rho_p - rho_m) > rho_eps
    return torch.where(use_up, rho_up, 0.5 * (rho_p + rho_m))


def calc_drhodt(U, V, rho_u_old, rho_v_old, dx: float, dy: float, rho_eps: float):
    """Consistent mass/density transport with the same hybrid fluxes.
    Returns (drho_u_dt, drho_v_dt) with synthesized ghost rings (:func:`_pad1`)."""
    # FXU = -rho*U on the center mesh
    rho_h = _hybrid_rho(rho_eps, rho_u_old[:-1, :], rho_u_old[1:, :], U[:-1, :], U[1:, :])
    FXU = -rho_h * 0.5 * (U[:-1, :] + U[1:, :])

    # FYU = -rho*V on the corner mesh
    u_lo, u_hi = U[1:-1, :-1], U[1:-1, 1:]
    v_lo, v_hi = V[:-1, 1:-1], V[1:, 1:-1]
    rho_h = _hybrid_rho(rho_eps, rho_u_old[1:-1, :-1], rho_u_old[1:-1, 1:], v_lo, v_hi)
    FYU = -rho_h * 0.5 * (v_lo + v_hi)

    drho_u = _pad1(
        (FXU[1:, 1:-1] - FXU[:-1, 1:-1]) / dx + (FYU[:, 1:] - FYU[:, :-1]) / dy
    )

    # FXV = -rho*U on the corner mesh
    rho_h = _hybrid_rho(rho_eps, rho_v_old[:-1, 1:-1], rho_v_old[1:, 1:-1], u_lo, u_hi)
    FXV = -rho_h * 0.5 * (u_lo + u_hi)

    # FYV = -rho*V on the center mesh
    rho_h = _hybrid_rho(rho_eps, rho_v_old[:, :-1], rho_v_old[:, 1:], V[:, :-1], V[:, 1:])
    FYV = -rho_h * 0.5 * (V[:, :-1] + V[:, 1:])

    drho_v = _pad1(
        (FXV[1:, :] - FXV[:-1, :]) / dx + (FYV[1:-1, 1:] - FYV[1:-1, :-1]) / dy
    )
    return drho_u, drho_v


def update_density(rho_u_old, rho_v_old, drho_u, drho_v, dt, rho_u, rho_v):
    """rho = rho_old + dt*drhodt on the interior (ghost ring of ``rho_*`` kept)."""
    rho_u = set_interior(rho_u, rho_u_old[1:-1, 1:-1] + dt * drho_u[1:-1, 1:-1])
    rho_v = set_interior(rho_v, rho_v_old[1:-1, 1:-1] + dt * drho_v[1:-1, 1:-1])
    return rho_u, rho_v


def update_velocity(U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, dmomU, dmomV, dt, U, V):
    """U = (rho_old*U_old + dt*dmomUdt)/rho on the interior."""
    U = set_interior(
        U,
        (rho_u_old[1:-1, 1:-1] * U_old[1:-1, 1:-1] + dt * dmomU[1:-1, 1:-1]) / rho_u[1:-1, 1:-1],
    )
    V = set_interior(
        V,
        (rho_v_old[1:-1, 1:-1] * V_old[1:-1, 1:-1] + dt * dmomV[1:-1, 1:-1]) / rho_v[1:-1, 1:-1],
    )
    return U, V


def adjust_dt(U, V, rho_u, rho_v, visc, dx: float, dy: float,
              rho_gas: float, rho_liquid: float, sigma: float,
              cfl_max: float, dt_max: float) -> torch.Tensor:
    """Convective + viscous + capillary CFL limit (0-d tensor)."""
    if sigma > 0.0:
        cfl_st = 1.0 / math.sqrt(((rho_gas + rho_liquid) * (dx * dy) ** 1.5) / (4.0 * math.pi * sigma))
    else:
        cfl_st = 0.0

    u_c = 0.5 * (U[1:-2, 1:-1] + U[2:-1, 1:-1])
    v_c = 0.5 * (V[1:-1, 1:-2] + V[1:-1, 2:-1])
    cfl_cx = torch.clamp_min(torch.max(u_c) / dx, 0.0)
    cfl_cy = torch.clamp_min(torch.max(v_c) / dy, 0.0)

    rho_c = 0.25 * (
        rho_u[1:-2, 1:-1] + rho_u[2:-1, 1:-1] + rho_v[1:-1, 1:-2] + rho_v[1:-1, 2:-1]
    )
    cfl_vx = torch.clamp_min(torch.max(4.0 * visc[1:-1, 1:-1] / (dx * dx * rho_c)), 0.0)
    cfl_vy = torch.clamp_min(torch.max(4.0 * visc[1:-1, 1:-1] / (dy * dy * rho_c)), 0.0)

    cfl = torch.maximum(torch.maximum(cfl_cx, cfl_cy), torch.maximum(cfl_vx, cfl_vy))
    cfl = torch.clamp_min(cfl, cfl_st)
    return torch.clamp_max(cfl_max / cfl, dt_max)


def conserved_quantities(U, V, rho_u, rho_v, dx: float, dy: float):
    """Mass, x- and y-momentum over the staggered interior (the reference's
    src/FS.hpp:653-676), three 0-d tensors."""
    vol = dx * dy
    mass = torch.sum(
        0.25 * (rho_u[1:-2, 1:-1] + rho_u[2:-1, 1:-1] + rho_v[1:-1, 1:-2] + rho_v[1:-1, 2:-1])
    ) * vol
    mom_x = torch.sum(
        0.5 * (rho_u[1:-2, 1:-1] * U[1:-2, 1:-1] + rho_u[2:-1, 1:-1] * U[2:-1, 1:-1])
    ) * vol
    mom_y = torch.sum(
        0.5 * (rho_v[1:-1, 1:-2] * V[1:-1, 1:-2] + rho_v[1:-1, 2:-1] * V[1:-1, 2:-1])
    ) * vol
    return mass, mom_x, mom_y


def inflow_outflow(U, rho_u):
    """Mass flux through the left and right ghost faces, and their imbalance."""
    inflow = torch.sum(rho_u[0, :] * U[0, :])
    outflow = torch.sum(rho_u[-1, :] * U[-1, :])
    return inflow, outflow, outflow - inflow


def correct_outflow(U, rho_u, mass_error):
    """Spread the mass imbalance over the outflow ghost face."""
    U = U.clone()
    U[-1, :] += -mass_error / (rho_u[-1, :] * U.shape[1])
    return U


# ---- two-phase property mixing ---------------------------------------------
def mix_rho_staggered(vf, rho_gas: float, rho_liquid: float):
    """Linear-by-volume-fraction density averaged onto the staggered faces;
    ghost ring by Neumann fill. Returns (rho_u, rho_v)."""
    rho_c = vf * rho_liquid + (1.0 - vf) * rho_gas
    rho_u = apply_neumann_scalar(pad_interior(0.5 * (rho_c[:-1, :] + rho_c[1:, :])[:, 1:-1]))
    rho_v = apply_neumann_scalar(pad_interior(0.5 * (rho_c[:, :-1] + rho_c[:, 1:])[1:-1, :]))
    return rho_u, rho_v


def mix_visc(vf, visc_gas: float, visc_liquid: float, arithmetic: bool = False):
    """Harmonic (default) or arithmetic viscosity on cell centers, with the
    pure-phase cutoffs of ``constants.vf_cutoffs``; Neumann ghost fill."""
    if arithmetic:
        visc = vf * visc_liquid + (1.0 - vf) * visc_gas
    else:
        lo, hi = vf_cutoffs(vf.dtype)
        harmonic = (visc_liquid * visc_gas) / (visc_liquid * (1.0 - vf) + visc_gas * vf)
        visc = torch.where(vf < lo, torch.full_like(vf, visc_gas),
                           torch.where(vf > hi, torch.full_like(vf, visc_liquid), harmonic))
    return apply_neumann_scalar(visc)


# ---- surface tension as a staggered pressure jump ---------------------------
def _face_curvature(curv_m, curv_p, len_m, len_p):
    """Interface-length-weighted average of the two cells' curvatures; 0
    where neither cell has an interface."""
    total = len_m + len_p
    has = total > 0.0
    avg = (curv_p * len_p + curv_m * len_m) / torch.where(has, total, torch.ones_like(total))
    return torch.where(has, avg, torch.zeros_like(avg))


def calc_pressure_jump(vf, curv, interface_length, sigma: float, dx: float, dy: float):
    """p_jump = sigma * kappa_face * grad(vf) on the interior faces (zero
    ghost rings). Returns (p_jump_u, p_jump_v)."""
    L = interface_length
    curv_face = _face_curvature(curv[:-1, 1:-1], curv[1:, 1:-1], L[:-1, 1:-1], L[1:, 1:-1])
    p_jump_u = pad_interior(sigma * curv_face * (vf[1:, 1:-1] - vf[:-1, 1:-1]) / dx)
    curv_face = _face_curvature(curv[1:-1, :-1], curv[1:-1, 1:], L[1:-1, :-1], L[1:-1, 1:])
    p_jump_v = pad_interior(sigma * curv_face * (vf[1:-1, 1:] - vf[1:-1, :-1]) / dy)
    return p_jump_u, p_jump_v


# ---- surface tension as explicit tangential forces ---------------------------
def calc_surface_tension_force(rec_nx, rec_ny, valid, sigma: float):
    """The reference's alternative capillary model (src/FS.hpp:469-566): at
    each face whose two cells both carry a PLIC reconstruction, the face-
    normal component of sigma * (t_right - t_left), the cells' tangents
    t = (-n_y, n_x) turned away from the face on the left (bottom) and
    towards +x (+y) on the right (top). ``valid``: the interior mixed
    cells. Returns (f_sigma_u, f_sigma_v) on the staggered grids, zero
    ghost rings."""
    tx, ty = -rec_ny, rec_nx
    zero = torch.zeros((), dtype=tx.dtype, device=tx.device)

    both = valid[:-1, 1:-1] & valid[1:, 1:-1]
    t_left = torch.where(tx[:-1, 1:-1] > 0.0, -tx[:-1, 1:-1], tx[:-1, 1:-1])
    t_right = torch.where(tx[1:, 1:-1] < 0.0, -tx[1:, 1:-1], tx[1:, 1:-1])
    f_sigma_u = pad_interior(torch.where(both, sigma * (t_right - t_left), zero))

    both = valid[1:-1, :-1] & valid[1:-1, 1:]
    t_bot = torch.where(ty[1:-1, :-1] > 0.0, -ty[1:-1, :-1], ty[1:-1, :-1])
    t_top = torch.where(ty[1:-1, 1:] < 0.0, -ty[1:-1, 1:], ty[1:-1, 1:])
    f_sigma_v = pad_interior(torch.where(both, sigma * (t_top - t_bot), zero))
    return f_sigma_u, f_sigma_v


def fused_momentum(U, V, U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, visc, p,
                        pj_u, pj_v, dt, *, dx: float, dy: float, rho_eps: float,
                        gx: float = 0.0, gy: float = 0.0):
    """One two-phase subiteration's momentum stage, grouped as the port's
    kernel #8 groups it: ``calc_drhodt`` -> ``update_density`` ->
    ``calc_dmomdt`` -> gravity on the interior (only where non-zero) ->
    ``update_velocity``. Returns (rho_u', rho_v', U', V')."""
    drho_u, drho_v = calc_drhodt(U, V, rho_u_old, rho_v_old, dx, dy, rho_eps)
    rho_u, rho_v = update_density(rho_u_old, rho_v_old, drho_u, drho_v, dt, rho_u, rho_v)
    dmomU, dmomV = calc_dmomdt(U, V, rho_u_old, rho_v_old, visc, p, pj_u, pj_v, dx, dy,
                                   rho_eps)
    if gx != 0.0:
        dmomU = add_interior(dmomU, rho_u[1:-1, 1:-1] * gx)
    if gy != 0.0:
        dmomV = add_interior(dmomV, rho_v[1:-1, 1:-1] * gy)
    U, V = update_velocity(U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, dmomU, dmomV,
                               dt, U, V)
    return rho_u, rho_v, U, V
