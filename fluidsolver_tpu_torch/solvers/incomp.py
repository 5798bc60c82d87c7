"""Single-phase incompressible fractional-step solver: port of
``fluidsolver_tpu.solvers.incomp``.

One step: adaptive CFL dt, state rotation, then ``num_subiter``
subiterations of { Crank-Nicolson midpoint -> momentum RHS -> velocity
update -> BCs -> optional outflow correction -> divergence -> pressure
solve -> gauge shift -> projection }.

The pressure solve takes the JAX package's whole surface: ``pressure_method``
"pcg", "bicgstab", "gmres" or "mgsolve" around ``pressure_solver`` "mg",
"boxmg", "jacobi" or "none", or ``pressure_solver="direct"`` (dense, small
boxes). ``pressure_precond_dtype`` ("bfloat16") runs the "mg" or "boxmg"
V-cycle on a hierarchy stored in that dtype (``poisson.cg.make_m_inv``);
the iteration itself stays in the state's dtype.

Immersed boundaries (``cfg.ib_mode`` with the fields ``ib`` passed to
``make_step``): "luchini" replaces the velocity update by the exponential
integrator, "luchini_implicit" divides the updated velocity, "diffuse" and
"sharp" force the velocity after the outflow correction, before the
divergence. ``ib`` may be a callable of the state (a solid that moves with
time) and ``div_source(state, dt)`` adds a mass source to the divergence;
both are evaluated on the device. The step reads ``dt > 0`` and each
solver iteration's exit test back to the host (``core.sync``).

Each stage runs inside a profiler range (``utils.profiling.annotate``):
``DT_RANGE``, and in each subiteration ``MOMENTUM_RANGE`` (with the BCs,
the flow and IB forcing), ``RHS_RANGE``, ``PRESSURE_RANGE`` and
``PROJECTION_RANGE``; the two-phase step opens the same ones. Outside them
are only ``dt > 0``, the zero warm start of the subiterations and
``t + dt``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from fluidsolver_tpu_torch.core import bc as bc_mod
from fluidsolver_tpu_torch.core import fields, sync
from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.ib import diffuse, luchini, sharp
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.poisson import _kernels, cg, krylov, linsys
from fluidsolver_tpu_torch.poisson.direct import solve_direct
from fluidsolver_tpu_torch.solvers.config import SolverConfig
from fluidsolver_tpu_torch.solvers.state import (FlowState, clamp_dt_to_end,
                                                  end_tolerance, save_old)
from fluidsolver_tpu_torch.utils import profiling


PRESSURE_SOLVERS = ("mg", "boxmg", "jacobi", "none", "direct")
PRESSURE_METHODS = ("pcg", "bicgstab", "gmres", "mgsolve")
IB_MODES = (None, "diffuse", "sharp", "luchini", "luchini_implicit")

# profiler ranges around the stages of a step, shared by the two-phase step
# (which adds ``twophase.vof``); the benchmark's trace reader takes ranges
# by their ``twophase.`` and ``pcg.`` prefixes, so the single-phase step
# names its stages under ``twophase.`` too
DT_RANGE = "twophase.dt"
MOMENTUM_RANGE = "twophase.momentum"
RHS_RANGE = "twophase.rhs"
PRESSURE_RANGE = "twophase.pressure"
PROJECTION_RANGE = "twophase.projection"


def _check_supported(cfg: SolverConfig) -> None:
    if cfg.pressure_solver not in PRESSURE_SOLVERS:
        raise ValueError(f"unknown pressure_solver: {cfg.pressure_solver!r}")
    if cfg.pressure_method not in PRESSURE_METHODS:
        raise ValueError(f"unknown pressure_method: {cfg.pressure_method!r}")
    if cfg.pressure_method == "mgsolve" and cfg.pressure_solver not in ("mg", "boxmg"):
        raise ValueError("pressure_method='mgsolve' needs pressure_solver in {'mg', 'boxmg'} "
                         "(the V-cycle is the solver)")
    if cfg.pressure_precond_dtype is not None:
        _kernels.torch_dtype(cfg.pressure_precond_dtype)  # raises on a name that is no float dtype
    if cfg.ib_mode not in IB_MODES:
        raise ValueError(f"unknown ib_mode: {cfg.ib_mode!r}")


def _periodic_axes(cfg: SolverConfig) -> tuple[bool, bool]:
    b = cfg.bcs
    per_x = isinstance(b.left, bc_mod.Periodic) and isinstance(b.right, bc_mod.Periodic)
    per_y = isinstance(b.bottom, bc_mod.Periodic) and isinstance(b.top, bc_mod.Periodic)
    return per_x, per_y


def pressure_solve(state: FlowState, div, dt, grid: Grid, cfg: SolverConfig,
                   x0=None, levels=None, tol: Optional[float] = None, mesh=None):
    """Assemble and solve the pressure Poisson system; returns the gauge-
    shifted increment delta_p, the relative residual and the iterations
    (``direct``: 0 and 1). ``x0``: a warm-start guess; ``levels``: a
    prebuilt hierarchy of ``cfg.pressure_solver``; ``mesh``: a
    ``parallel.mesh.SlabMesh``, which routes the solve through the
    distributed BoxMG-PCG (``parallel/dist_poisson.py``; ``levels`` then
    from :func:`build_step_levels_sharded`)."""
    _check_supported(cfg)
    if tol is None:
        tol = cfg.pressure_tol
    op = linsys.assemble_pressure_operator(state.rho_u, state.rho_v, grid.dx, grid.dy,
                                           cfg.pressure_pin)
    per_x, per_y = _periodic_axes(cfg)
    rhs = linsys.build_pressure_rhs(div, grid.dx, grid.dy, dt, cfg.pressure_pin,
                                    periodic_x=per_x, periodic_y=per_y)
    singular = cfg.pressure_pin is None
    if mesh is not None:
        if cfg.pressure_method != "pcg":
            raise ValueError("multi-chip pressure solve supports pressure_method='pcg' "
                             f"only (got {cfg.pressure_method!r})")
        from fluidsolver_tpu_torch.parallel import dist_poisson

        delta_p, rel, iters = dist_poisson.solve_pcg_sharded(
            mesh, op, rhs, tol=tol, max_iter=cfg.pressure_max_iter, singular=singular,
            n_pre=cfg.mg_pre, n_post=cfg.mg_post, x0=x0 if cfg.pressure_warm_start else None,
            levels=levels)
    elif cfg.pressure_solver == "direct":
        delta_p = solve_direct(op, rhs, singular)
        rel, iters = torch.zeros((), dtype=rhs.dtype, device=rhs.device), 1
    elif cfg.pressure_method == "pcg":
        delta_p, rel, iters = cg.solve_pcg(
            op, rhs, tol=tol, max_iter=cfg.pressure_max_iter, singular=singular,
            precond=cfg.pressure_solver, n_pre=cfg.mg_pre, n_post=cfg.mg_post, x0=x0,
            levels=levels, precond_dtype=cfg.pressure_precond_dtype,
        )
    else:
        M_inv, _ = cg.make_m_inv(op, cfg.pressure_solver, levels=levels, n_pre=cfg.mg_pre,
                                 n_post=cfg.mg_post, precond_dtype=cfg.pressure_precond_dtype)
        common = dict(tol=tol, max_iter=cfg.pressure_max_iter, singular=singular, M_inv=M_inv,
                      x0=x0)
        if cfg.pressure_method == "bicgstab":
            delta_p, rel, iters = krylov.solve_bicgstab(op, rhs, **common)
        elif cfg.pressure_method == "gmres":
            delta_p, rel, iters = krylov.solve_gmres(op, rhs, restart=cfg.pressure_gmres_restart,
                                                     **common)
        else:
            delta_p, rel, iters = krylov.solve_mg(op, rhs, **common)
    return stencil.shift_pressure_to_zero(delta_p, grid.dx, grid.dy), rel, iters


def build_step_levels(rho_u, rho_v, grid: Grid, cfg: SolverConfig):
    """The multigrid hierarchy of the operator assembled from these
    densities (in ``cfg.pressure_precond_dtype`` if set), or None for a
    solver without one."""
    _check_supported(cfg)
    if cfg.pressure_solver not in ("mg", "boxmg"):
        return None
    op = linsys.assemble_pressure_operator(rho_u, rho_v, grid.dx, grid.dy, cfg.pressure_pin)
    return cg.build_precond_levels(op, cfg.pressure_solver, cfg.pressure_precond_dtype)


def build_step_levels_sharded(rho_u, rho_v, grid: Grid, cfg: SolverConfig, mesh):
    """The mesh's :func:`build_step_levels`: the distributed BoxMG hierarchy
    (``dist_poisson.build_hierarchy_sharded``) of the operator of these
    densities, for ``pressure_solve(mesh=, levels=)``; None for a solver
    without a hierarchy."""
    if cfg.pressure_solver not in ("mg", "boxmg"):
        return None
    from fluidsolver_tpu_torch.parallel import dist_poisson

    op = linsys.assemble_pressure_operator(rho_u, rho_v, grid.dx, grid.dy, cfg.pressure_pin)
    return dist_poisson.build_hierarchy_sharded(mesh, op)


def project_velocity(U, V, delta_p, rho_u, rho_v, dt, dx: float, dy: float):
    """U -= dt/rho * grad(delta_p) on interior faces."""
    dpdx = (delta_p[1:, 1:-1] - delta_p[:-1, 1:-1]) / dx
    U = fields.add_interior(U, -dpdx * dt / rho_u[1:-1, 1:-1])
    dpdy = (delta_p[1:-1, 1:] - delta_p[1:-1, :-1]) / dy
    V = fields.add_interior(V, -dpdy * dt / rho_v[1:-1, 1:-1])
    return U, V


def make_step(grid: Grid, cfg: SolverConfig, dtype: torch.dtype, device, ib=None,
              div_source: Optional[Callable] = None) -> Callable:
    """Build ``step(state, t_end) -> state`` for states of ``dtype`` on
    ``device``. ``ib``: the immersed-boundary fields of ``cfg.ib_mode``
    (``ib.diffuse.DiffuseIB``, ``ib.sharp.SharpIB`` or
    ``ib.luchini.LuchiniIB`` on ``device``), or a callable of the state
    that returns them; ``div_source(state, dt)``: a cell-centred field added
    to the divergence before each pressure solve.

    Single-phase density is constant (``cfg.rho_gas``), so the multigrid
    hierarchy ("mg" or "boxmg") is built here once, on ``device``, from
    constant densities: on a GPU this is where BoxMG's setup kernels run.
    The solver's operator itself is assembled from ``state.rho_u``/``rho_v``
    at every solve."""
    _check_supported(cfg)
    if cfg.ib_mode is not None and ib is None:
        raise ValueError(f"ib_mode={cfg.ib_mode!r} requires precomputed ib fields")
    device = torch.device(device)
    rho_eps = mom.calc_rho_eps(cfg.rho_gas, cfg.rho_liquid)
    levels = build_step_levels(fields.full_u(grid, cfg.rho_gas, dtype, device),
                               fields.full_v(grid, cfg.rho_gas, dtype, device), grid, cfg)

    def subiter(state: FlowState, dp_prev, dt, k: int):
        with profiling.annotate(MOMENTUM_RANGE):
            ib_f = ib(state) if callable(ib) else ib
            U = stencil.mid_time(state.U, state.U_old)
            V = stencil.mid_time(state.V, state.V_old)
            dmomU, dmomV = mom.calc_dmomdt(
                U, V, state.rho_u_old, state.rho_v_old, state.visc, state.p,
                state.p_jump_u, state.p_jump_v, grid.dx, grid.dy, rho_eps,
            )
            if cfg.gravity != (0.0, 0.0):
                gx, gy = cfg.gravity
                dmomU = fields.add_interior(dmomU, gx * state.rho_u[1:-1, 1:-1])
                dmomV = fields.add_interior(dmomV, gy * state.rho_v[1:-1, 1:-1])
            if cfg.ib_mode == "luchini":
                U, V = luchini.update_velocity_semi_analytical(
                    dmomU, dmomV, dt, ib_f, state.U_old, state.V_old, state.rho_u_old,
                    state.rho_v_old, state.rho_u, state.rho_v, state.visc, U, V)
            else:
                U, V = mom.update_velocity(
                    state.U_old, state.V_old, state.rho_u_old, state.rho_v_old,
                    state.rho_u, state.rho_v, dmomU, dmomV, dt, U, V,
                )
                if cfg.ib_mode == "luchini_implicit":
                    U, V = luchini.correct_velocity_implicit_euler(U, V, ib_f, dt, state.visc,
                                                                   state.rho_u, state.rho_v)
            U, V = bc_mod.apply_velocity_bcs(U, V, grid, cfg.bcs, state.t)

            if cfg.outflow_correction:
                _, _, mass_err = mom.inflow_outflow(U, state.rho_u)
                U = mom.correct_outflow(U, state.rho_u, mass_err)

            if cfg.flow_forcing is not None:
                # drive the periodic channel to a fixed total mass flow
                ncols = U.shape[1]
                inflow = torch.sum(state.rho_u[0, :] * U[0, :] * grid.dy)
                outflow = torch.sum(state.rho_u[-1, :] * U[-1, :] * grid.dy)
                U = U.clone()
                U[0, :] += (cfg.flow_forcing - inflow) / (state.rho_u[0, :] * grid.dy * ncols)
                U[-1, :] += (cfg.flow_forcing - outflow) / (state.rho_u[-1, :] * grid.dy * ncols)

            if cfg.ib_mode == "diffuse":
                U, V, _, _ = diffuse.apply_direct_forcing(U, V, ib_f)
            elif cfg.ib_mode == "sharp":
                U, V = sharp.apply_forcing(U, V, ib_f)

        with profiling.annotate(RHS_RANGE):
            div = stencil.divergence(U, V, grid.dx, grid.dy)
            if div_source is not None:
                div = div + div_source(state, dt)
        tol = cfg.pressure_tol
        if cfg.pressure_tol_intermediate is not None and k != cfg.num_subiter - 1:
            tol = cfg.pressure_tol_intermediate
        with profiling.annotate(PRESSURE_RANGE):
            delta_p, rel, iters = pressure_solve(
                state, div, dt, grid, cfg,
                x0=dp_prev if cfg.pressure_warm_start else None, levels=levels, tol=tol,
            )
        with profiling.annotate(PROJECTION_RANGE):
            p = state.p + delta_p
            U, V = project_velocity(U, V, delta_p, state.rho_u, state.rho_v, dt, grid.dx, grid.dy)
            return dataclasses.replace(state, U=U, V=V, p=p, p_res=rel,
                                       p_iter=state.p_iter + iters), delta_p

    def step(state: FlowState, t_end: float) -> FlowState:
        if state.U.dtype != dtype or state.U.device != device:
            raise ValueError(f"step built for {dtype} on {device}, state is "
                             f"{state.U.dtype} on {state.U.device}")
        with profiling.annotate(DT_RANGE):
            dt = mom.adjust_dt(
                state.U, state.V, state.rho_u, state.rho_v, state.visc,
                grid.dx, grid.dy, cfg.rho_gas, cfg.rho_liquid, cfg.sigma,
                cfg.cfl_max, cfg.dt_max,
            )
            dt = clamp_dt_to_end(dt, state.t, t_end)
            state = save_old(state)
            state = dataclasses.replace(state, p_iter=torch.zeros_like(state.p_iter))
        # dt == 0 (t_end reached) skips the physics: the Poisson RHS divides
        # by dt. Each subiteration warm-starts from the previous increment.
        if sync.read(dt > 0.0):
            dp = torch.zeros_like(state.p)
            for k in range(cfg.num_subiter):
                state, dp = subiter(state, dp, dt, k)
        return dataclasses.replace(state, t=state.t + dt, dt=dt)

    step.levels = levels
    return step


def run(state: FlowState, t_end: float, grid: Grid, cfg: SolverConfig,
        callback=None, max_steps: int = 1_000_000) -> FlowState:
    """Host time loop: while t < t_end."""
    step = make_step(grid, cfg, state.U.dtype, state.U.device)
    tol = end_tolerance(state.t.dtype, t_end)
    for _ in range(max_steps):
        if sync.read(state.t) >= t_end - tol:
            break
        state = step(state, t_end)
        if callback is not None:
            callback(state)
    return state


def make_fixed_runner(grid: Grid, cfg: SolverConfig, n_steps: int, dtype: torch.dtype,
                      device, ib=None, div_source: Optional[Callable] = None) -> Callable:
    """Fixed-step runner (the JAX package's ``make_scan_runner``): ``n_steps``
    steps; steps past ``t_end`` clamp to dt = 0 no-ops."""
    step = make_step(grid, cfg, dtype, device, ib=ib, div_source=div_source)

    def run_n(state: FlowState, t_end: float) -> FlowState:
        for _ in range(n_steps):
            state = step(state, t_end)
        return state

    return run_n
