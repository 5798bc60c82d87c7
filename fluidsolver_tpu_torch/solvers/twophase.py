"""Two-phase VOF Navier-Stokes solver: port of
``fluidsolver_tpu.solvers.twophase``.

One step: dt (CFL with the capillary and gravity limits) -> state rotation
-> ELVIRA reconstruction of vf_old (kernel #10) -> density from vf_old ->
geometric VOF advection (kernel #12) -> viscosity from the new vf ->
curvature (kernel #11, or a plain-PyTorch estimator) and interface length
from the vf_old reconstruction -> ``num_subiter`` subiterations of {
Crank-Nicolson midpoint; consistent density transport; momentum with hybrid
upwinding and gravity; BCs and the outflow correction; divergence plus the
capillary term and the phase-change source; pressure solve; projection }.

Options, as in the JAX package: the pressure solvers of
``solvers/incomp.py``; ``vof_max_active`` (0: the dense advection) and
the A/B advection variants ``vof_no_correction`` and
``vof_staggered_backtrace``; ``curvature_method`` "volume_matching",
"regression" or "convolved"; ``surface_tension_method`` "pressure_jump"
(the jump increment folded into the RHS) or "tangent_force" (the
divergence of the explicit tangential pull in the RHS, p_jump left as it
is); ``phase_change_mdot`` (the PLIC planes shifted into the liquid by the
Stefan displacement before the advection, and each mixed cell's m_dot A
spread as a divergence source over the pure-liquid cells of its 3x3 box).
``pressure_precond_refresh`` "solve" builds the multigrid hierarchy ("mg"
or "boxmg") inside every solve; "step" builds it once per step from
subiteration 0's transported densities and reuses it for the rest; a
solver without a hierarchy has none to build; with
``pressure_precond_dtype`` ("bfloat16") it is built and cast once a step.
Other refresh policies raise.

``make_step(mesh=)`` takes a ``parallel.mesh.SlabMesh`` (the JAX
package's x-slab ``jax.sharding.Mesh``): the pressure solve runs the
distributed BoxMG-PCG of ``parallel/dist_poisson.py`` (with refresh "step"
its hierarchy is built at subiteration 0 and carried), and the sparse
advection runs slab by slab (``parallel/dist_vof.py``) when
``vof_max_active`` is not 0, the trace is not staggered and the slabs are
tall enough; otherwise the dense advection runs. Every other stage works
on global fields on the mesh's first device, where the state lives.

The step runs the reference's fused composition (its ``FS_PALLAS_CG`` and
``FS_PALLAS_MOMENTUM``): the fused PCG iteration (kernels 5-7, in
``poisson/cg.py``) and the fused momentum stage (kernel 8,
``ops/cuda_momentum.py``); under "pressure_jump" the RHS stage is one
kernel too (kernel 13, ``ops/cuda_rhs.py``).

``make_kinematic_step`` is the VOF stage alone under a prescribed
velocity (ELVIRA, advection, interface length; no momentum, no pressure).

Host reads per step: ``dt > 0`` and each solver iteration's exit test
(``core.sync``); the VOF stage adds none, so the kinematic step has none.
Each stage runs inside a profiler range (``utils.profiling.annotate``):
``DT_RANGE``, ``VOF_RANGE``, and in each subiteration ``MOMENTUM_RANGE``,
``RHS_RANGE``, ``PRESSURE_RANGE`` (the solve with its hierarchy build) and
``PROJECTION_RANGE``. Outside them are only ``dt > 0``, the zero warm
start of the subiterations and ``t + dt``.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Mapping
from typing import Callable

import numpy as np
import torch

from fluidsolver_tpu_torch.constants import vf_cutoffs
from fluidsolver_tpu_torch.core import bc as bc_mod
from fluidsolver_tpu_torch.core import fields, sync
from fluidsolver_tpu_torch.core.grid import Grid
from fluidsolver_tpu_torch.ops import cuda_momentum, cuda_rhs
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.solvers import incomp
from fluidsolver_tpu_torch.solvers.config import SolverConfig
from fluidsolver_tpu_torch.solvers.incomp import (DT_RANGE, MOMENTUM_RANGE, PRESSURE_RANGE,
                                                   PROJECTION_RANGE, RHS_RANGE)
from fluidsolver_tpu_torch.solvers.state import (FlowState, clamp_dt_to_end, end_tolerance,
                                                  init_flow_state, state_from_numpy,
                                                  state_to_numpy)
from fluidsolver_tpu_torch.utils import profiling
from fluidsolver_tpu_torch.vof import advect as adv
from fluidsolver_tpu_torch.vof import plic
from fluidsolver_tpu_torch.vof.curvature import (curvature_convolved_vf, curvature_quad_regression,
                                                  curvature_quad_volume_matching)


# the profiler range around the VOF stage; the other stages' are
# ``incomp``'s, shared by both steps
VOF_RANGE = "twophase.vof"


@dataclasses.dataclass
class TwoPhaseState:
    flow: FlowState
    vf: torch.Tensor
    vf_old: torch.Tensor
    curv: torch.Tensor
    interface_length: torch.Tensor
    vof_vol_error: torch.Tensor


def init_two_phase_state(grid: Grid, cfg: SolverConfig, vf0, dtype: torch.dtype,
                         device) -> TwoPhaseState:
    """Quiescent state with the volume fractions ``vf0`` (numpy or tensor
    over the full ghost box, e.g. from ``vof.init.liquid_fraction_from_indicator``)."""
    flow = init_flow_state(grid, cfg.rho_gas, cfg.visc_gas, dtype, device)
    vf = torch.as_tensor(np.asarray(vf0), dtype=dtype, device=device)
    rho_u, rho_v = mom.mix_rho_staggered(vf, cfg.rho_gas, cfg.rho_liquid)
    visc = mom.mix_visc(vf, cfg.visc_gas, cfg.visc_liquid, cfg.arithmetic_visc)
    flow = dataclasses.replace(flow, rho_u=rho_u, rho_v=rho_v, rho_u_old=rho_u,
                               rho_v_old=rho_v, visc=visc)
    return TwoPhaseState(flow=flow, vf=vf, vf_old=vf, curv=torch.zeros_like(vf),
                         interface_length=torch.zeros_like(vf),
                         vof_vol_error=torch.zeros((), dtype=dtype, device=device))


_VOF_FIELDS = ("vf", "vf_old", "curv", "interface_length", "vof_vol_error")


def two_phase_state_from_numpy(arrays, device) -> TwoPhaseState:
    """A ``TwoPhaseState`` on ``device`` from numpy arrays: a mapping with
    a ``flow`` mapping and the VOF fields, or any object with those
    attributes (e.g. the JAX package's state). Dtypes are kept."""
    get = arrays.__getitem__ if isinstance(arrays, Mapping) else (lambda n: getattr(arrays, n))
    return TwoPhaseState(flow=state_from_numpy(get("flow"), device), **{
        name: torch.as_tensor(np.array(get(name)), device=device) for name in _VOF_FIELDS})


def two_phase_state_to_numpy(state: TwoPhaseState) -> dict:
    """{"flow": field name -> array, and each VOF field -> array}."""
    out = {name: getattr(state, name).detach().cpu().numpy() for name in _VOF_FIELDS}
    out["flow"] = state_to_numpy(state.flow)
    return out


CURVATURE = {"volume_matching": curvature_quad_volume_matching,
             "regression": curvature_quad_regression,
             "convolved": curvature_convolved_vf}


def _check_supported(cfg: SolverConfig) -> None:
    if cfg.pressure_precond_refresh not in ("solve", "step"):
        raise ValueError(f"pressure_precond_refresh={cfg.pressure_precond_refresh!r}: "
                         "use 'solve' or 'step'")
    if cfg.surface_tension_method not in ("pressure_jump", "tangent_force"):
        raise ValueError(f"unknown surface_tension_method: {cfg.surface_tension_method!r}")
    if cfg.curvature_method not in CURVATURE:
        raise ValueError(f"unknown curvature_method: {cfg.curvature_method!r}")


def _phase_change_source(vf_old, m_dot_A, cfg: SolverConfig, grid: Grid):
    """The expansion source on the pure-liquid interior cells: the m_dot A
    of the 3x3 box over the box's share of pure liquid, times the specific
    volume jump, per cell area (examples/ExpandingBubble.cpp:302-321)."""
    pure = (vf_old >= vf_cutoffs(vf_old.dtype)[1]).to(vf_old.dtype)

    def box3(f):
        # the 3x3 sum over the interior: every neighbour lies in the box
        total = torch.zeros_like(f[1:-1, 1:-1])
        for di, dj in plic.NEIGHBOR_OFFSETS:
            total = total + plic.shift(f, di, dj)
        return total

    avg = box3(pure) / 9.0
    msum = box3(m_dot_A)
    avg_safe = torch.where(avg > 0.0, avg, torch.ones_like(avg))
    src = msum / avg_safe * (1.0 / cfg.rho_gas - 1.0 / cfg.rho_liquid) / (grid.dx * grid.dy)
    return torch.where(pure[1:-1, 1:-1] > 0.0, src, torch.zeros_like(src))


def _tangent_force_rhs(rec, dt, cfg: SolverConfig, grid: Grid):
    """The divergence term of the tangential pull (TwoPhaseSolver.cpp:348-355,
    with its calibration ``tangent_force_scale``) over the interior."""
    fsu, fsv = mom.calc_surface_tension_force(rec.nx, rec.ny, rec.valid, cfg.sigma)
    return -dt * cfg.tangent_force_scale * (
        (fsu[2:-1, 1:-1] - fsu[1:-2, 1:-1]) / grid.dx
        + (fsv[1:-1, 2:-1] - fsv[1:-1, 1:-2]) / grid.dy)


def make_step(grid: Grid, cfg: SolverConfig, dtype: torch.dtype, device, mesh=None) -> Callable:
    """Build ``step(state, t_end) -> state`` for states of ``dtype`` on
    ``device``. The multigrid hierarchy depends on the transported
    densities, so it is built inside the step (see the module doc).
    ``mesh``: a ``parallel.mesh.SlabMesh`` whose first device is
    ``device``; the step then makes the same host reads as without it."""
    incomp._check_supported(cfg)
    _check_supported(cfg)
    device = torch.device(device)
    if mesh is not None and mesh.devices[0] != device:
        raise ValueError(f"the state lives on the mesh's first device {mesh.devices[0]}, not {device}")
    # under a mesh the sparse advection runs slab by slab where it can, and
    # the dense one otherwise
    vof_budget = 0 if mesh is not None else cfg.vof_max_active
    vof_sharded = False
    if mesh is not None and cfg.vof_max_active != 0 and not cfg.vof_staggered_backtrace:
        from fluidsolver_tpu_torch.parallel import dist_vof

        vof_sharded = dist_vof.available(grid, len(mesh))
    rho_eps = mom.calc_rho_eps(cfg.rho_gas, cfg.rho_liquid)
    gx, gy = cfg.gravity
    per_step = cfg.pressure_precond_refresh == "step"

    tangent = cfg.surface_tension_method == "tangent_force"
    curvature = CURVATURE[cfg.curvature_method]

    def subiter(fs: FlowState, dp_prev, vof, dt, k: int, levels):
        # tangent_rhs / source: the tangential pull's and the phase change's
        # divergence terms over the interior (made once a step), or None
        vf_old, curv, iface_len, tangent_rhs, source = vof
        with profiling.annotate(MOMENTUM_RANGE):
            U = stencil.mid_time(fs.U, fs.U_old)
            V = stencil.mid_time(fs.V, fs.V_old)
            # consistent density transport, then momentum (+ gravity) in one
            # stage, which reads the densities' interior only: the Neumann
            # ghost fill comes after it
            rho_u, rho_v, U, V = cuda_momentum.fused_momentum(
                U, V, fs.U_old, fs.V_old, fs.rho_u_old, fs.rho_v_old, fs.rho_u, fs.rho_v, fs.visc,
                fs.p, fs.p_jump_u, fs.p_jump_v, dt, dx=grid.dx, dy=grid.dy, rho_eps=rho_eps, gx=gx,
                gy=gy)
            rho_u = bc_mod.apply_neumann_scalar(rho_u)
            rho_v = bc_mod.apply_neumann_scalar(rho_v)
            U, V = bc_mod.apply_velocity_bcs(U, V, grid, cfg.bcs, fs.t)
            if cfg.outflow_correction:
                _, _, mass_err = mom.inflow_outflow(U, rho_u)
                U = mom.correct_outflow(U, rho_u, mass_err)

        with profiling.annotate(RHS_RANGE):
            if tangent:
                # the tangential pull replaces the jump, which stays as it is
                pj_u, pj_v = fs.p_jump_u, fs.p_jump_v
                div = fields.add_interior(stencil.divergence(U, V, grid.dx, grid.dy), tangent_rhs)
            else:
                # capillary forcing: the pressure-jump increment folded into
                # the RHS, in one stage with the divergence
                div, pj_u, pj_v = cuda_rhs.fused_rhs(
                    U, V, vf_old, curv, iface_len, rho_u, rho_v, fs.p_jump_u, fs.p_jump_v, dt,
                    sigma=cfg.sigma, dx=grid.dx, dy=grid.dy)
            if source is not None:
                div = fields.add_interior(div, -source)
        fs = dataclasses.replace(fs, rho_u=rho_u, rho_v=rho_v, p_jump_u=pj_u, p_jump_v=pj_v)

        tol = cfg.pressure_tol
        if cfg.pressure_tol_intermediate is not None and k != cfg.num_subiter - 1:
            tol = cfg.pressure_tol_intermediate
        with profiling.annotate(PRESSURE_RANGE):
            if per_step and k == 0:
                levels = (incomp.build_step_levels(rho_u, rho_v, grid, cfg) if mesh is None else
                          incomp.build_step_levels_sharded(rho_u, rho_v, grid, cfg, mesh))
            delta_p, rel, iters = incomp.pressure_solve(
                fs, div, dt, grid, cfg, x0=dp_prev if cfg.pressure_warm_start else None,
                levels=levels if per_step else None, tol=tol, mesh=mesh)
        with profiling.annotate(PROJECTION_RANGE):
            p = fs.p + delta_p
            U, V = incomp.project_velocity(U, V, delta_p, rho_u, rho_v, dt, grid.dx, grid.dy)
            fs = dataclasses.replace(fs, U=U, V=V, p=p, p_res=rel, p_iter=fs.p_iter + iters)
        return fs, delta_p, levels

    def step(state: TwoPhaseState, t_end: float) -> TwoPhaseState:
        fs = state.flow
        if fs.U.dtype != dtype or fs.U.device != device:
            raise ValueError(f"step built for {dtype} on {device}, state is "
                             f"{fs.U.dtype} on {fs.U.device}")
        with profiling.annotate(DT_RANGE):
            dt = mom.adjust_dt(fs.U, fs.V, fs.rho_u, fs.rho_v, fs.visc, grid.dx, grid.dy,
                               cfg.rho_gas, cfg.rho_liquid, cfg.sigma, cfg.cfl_max, cfg.dt_max)
            if gy != 0.0:
                dt = torch.clamp_max(dt, cfg.cfl_max * math.sqrt(grid.dy / abs(gy)))
            if gx != 0.0:
                dt = torch.clamp_max(dt, cfg.cfl_max * math.sqrt(grid.dx / abs(gx)))
            dt = clamp_dt_to_end(dt, fs.t, t_end)
            # rotation: velocity now, density after remixing from vf_old
            fs = dataclasses.replace(fs, U_old=fs.U, V_old=fs.V)
        vf_old = state.vf
        with profiling.annotate(VOF_RANGE):
            rec = plic.elvira(vf_old, grid.dx, grid.dy)
            rho_u, rho_v = mom.mix_rho_staggered(vf_old, cfg.rho_gas, cfg.rho_liquid)
            fs = dataclasses.replace(fs, rho_u=rho_u, rho_v=rho_v, rho_u_old=rho_u,
                                     rho_v_old=rho_v)
            tangent_rhs = source = None
            if cfg.phase_change_mdot is not None:
                # the interfacial mass flux: each mixed cell's m_dot A for the
                # expansion source, and the Stefan shift of its plane into
                # the liquid, s = m_dot (1/rho_g - 1/rho_l) dt
                zero = torch.zeros_like(vf_old)
                m_dot_A = torch.where(rec.valid, plic.interface_length(rec, grid.dx, grid.dy)
                                      * cfg.phase_change_mdot, zero)
                stefan = cfg.phase_change_mdot * dt * (1.0 / cfg.rho_gas - 1.0 / cfg.rho_liquid)
                rec = dataclasses.replace(rec, d=torch.where(rec.valid, rec.d - stefan, rec.d))
                source = _phase_change_source(vf_old, m_dot_A, cfg, grid)
            Ui, Vi = stencil.interp_u_center(fs.U), stencil.interp_v_center(fs.V)
            if vof_sharded:
                vf, vol_err = dist_vof.advect_sharded(
                    mesh, vf_old, rec, fs.U, fs.V, Ui, Vi, grid, dt,
                    m_total=cfg.vof_max_active or adv.default_max_active(grid.nx, grid.ny),
                    no_correction=cfg.vof_no_correction)
            else:
                vf, vol_err = adv.advect(vf_old, rec, fs.U, fs.V, Ui, Vi, grid, dt,
                                         max_active=vof_budget,
                                         no_correction=cfg.vof_no_correction,
                                         staggered=cfg.vof_staggered_backtrace)
            vol_err = torch.where(rec.overflow, torch.full_like(vol_err, float("inf")), vol_err)

            # viscosity from the new vf; curvature and length from vf_old's planes
            visc = mom.mix_visc(vf, cfg.visc_gas, cfg.visc_liquid, cfg.arithmetic_visc)
            fs = dataclasses.replace(fs, visc=visc, p_iter=torch.zeros_like(fs.p_iter))
            curv = curvature(vf_old, rec, grid)
            iface_len = plic.interface_length(rec, grid.dx, grid.dy)
            if tangent:
                tangent_rhs = _tangent_force_rhs(rec, dt, cfg, grid)

        # dt == 0 (t_end reached) skips the physics: the Poisson RHS divides by dt
        if sync.read(dt > 0.0):
            dp = torch.zeros_like(fs.p)
            levels = None
            for k in range(cfg.num_subiter):
                fs, dp, levels = subiter(fs, dp, (vf_old, curv, iface_len, tangent_rhs, source),
                                         dt, k, levels)
        fs = dataclasses.replace(fs, t=fs.t + dt, dt=dt)
        return TwoPhaseState(flow=fs, vf=vf, vf_old=vf_old, curv=curv,
                             interface_length=iface_len, vof_vol_error=vol_err)

    return step


def run(state: TwoPhaseState, t_end: float, grid: Grid, cfg: SolverConfig,
        callback=None, max_steps: int = 1_000_000) -> TwoPhaseState:
    """Host time loop: while t < t_end."""
    step = make_step(grid, cfg, state.vf.dtype, state.vf.device)
    tol = end_tolerance(state.flow.t.dtype, t_end)
    for _ in range(max_steps):
        if sync.read(state.flow.t) >= t_end - tol:
            break
        state = step(state, t_end)
        if callback is not None:
            callback(state)
    return state


def make_fixed_runner(grid: Grid, cfg: SolverConfig, n_steps: int, dtype: torch.dtype,
                      device, mesh=None) -> Callable:
    """Fixed-step runner (the JAX package's ``make_scan_runner``): ``n_steps``
    steps; steps past ``t_end`` clamp to dt = 0. ``mesh``: see
    :func:`make_step`."""
    step = make_step(grid, cfg, dtype, device, mesh=mesh)

    def run_n(state: TwoPhaseState, t_end: float) -> TwoPhaseState:
        for _ in range(n_steps):
            state = step(state, t_end)
        return state

    return run_n


def make_kinematic_step(grid: Grid, cfg: SolverConfig, velocity: Callable, dtype: torch.dtype,
                        device) -> Callable:
    """VOF-only kinematic step for states of ``dtype`` on ``device``: the
    velocity is prescribed each step and only the interface is evolved
    (reconstruct -> advect); no momentum and no pressure solve. The
    reference's examples/VOF.cpp:80-120 and its kinematic tests
    (test/{ConstantVelocityVOF,LinearVelocityVOF,TaylorGreenVortexVOF}.cpp)
    share this loop shape.

    ``velocity(t) -> (U, V)``: the ghosted staggered fields at the step's
    0-d time tensor ``t``, on its device. The step makes no host read."""
    device = torch.device(device)

    def step(state: TwoPhaseState, t_end: float) -> TwoPhaseState:
        fs = state.flow
        if fs.U.dtype != dtype or fs.U.device != device:
            raise ValueError(f"step built for {dtype} on {device}, state is "
                             f"{fs.U.dtype} on {fs.U.device}")
        U, V = velocity(fs.t)
        U = U.to(fs.U.dtype)
        V = V.to(fs.V.dtype)
        dt = mom.adjust_dt(U, V, fs.rho_u, fs.rho_v, fs.visc, grid.dx, grid.dy, cfg.rho_gas,
                           cfg.rho_liquid, cfg.sigma, cfg.cfl_max, cfg.dt_max)
        dt = clamp_dt_to_end(dt, fs.t, t_end)

        vf_old = state.vf
        with profiling.annotate(VOF_RANGE):
            rec = plic.elvira(vf_old, grid.dx, grid.dy)
            vf, vol_err = adv.advect(vf_old, rec, U, V, stencil.interp_u_center(U),
                                     stencil.interp_v_center(V), grid, dt,
                                     max_active=cfg.vof_max_active)
            vol_err = torch.where(rec.overflow, torch.full_like(vol_err, float("inf")), vol_err)
            iface_len = plic.interface_length(rec, grid.dx, grid.dy)

        fs = dataclasses.replace(fs, U=U, V=V, U_old=fs.U, V_old=fs.V, t=fs.t + dt, dt=dt)
        return dataclasses.replace(state, flow=fs, vf=vf, vf_old=vf_old,
                                   interface_length=iface_len, vof_vol_error=vol_err)

    return step
