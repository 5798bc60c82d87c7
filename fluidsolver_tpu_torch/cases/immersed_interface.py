"""Lagrangian-marker immersed interface case (examples/II.cpp): port of
``fluidsolver_tpu.cases.immersed_interface``.

A closed elastic marker ring in a lid-driven box: the markers sample the
fluid velocity, advect, and react with F = K (X0 - X) - eta U; the force
is spread back to the staggered grid (Peskin delta) and enters the
momentum right-hand side of every subiteration. The state is an
``IIState`` (the flow and the markers); the step makes the pressure solve's
host reads (``core.sync``) and no other.
"""

from __future__ import annotations

import dataclasses

import torch

from fluidsolver_tpu_torch.cases.registry import Case, register
from fluidsolver_tpu_torch.core import bc
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ib import markers as mk
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.solvers import incomp
from fluidsolver_tpu_torch.solvers.config import SolverConfig
from fluidsolver_tpu_torch.solvers.state import FlowState, save_old


@dataclasses.dataclass
class IIState:
    flow: FlowState
    markers: mk.Markers


@register("immersed_interface")
def immersed_interface(n: int = 64, n_markers: int = 100, kappa: float = 1.0,
                       eta: float = 1.0) -> Case:
    g = make_grid(0.0, 1.0, n, 0.0, 1.0, n)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1.0, visc_gas=1e-2, visc_liquid=1e-2,
        cfl_max=0.5, dt_max=5e-3, num_subiter=2,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(bc.Dirichlet(), bc.Dirichlet(), bc.Dirichlet(),
                       bc.Dirichlet(u=1.0, v=0.0)),
    )
    case = Case("immersed_interface", g, cfg, t_end=2.0, dt_write=2e-2,
                meta=dict(kappa=kappa, eta=eta, n_markers=n_markers))
    base_make_state = case.make_state

    def make_state(dtype: torch.dtype, device) -> IIState:
        flow = base_make_state(dtype, device)
        return IIState(flow=flow, markers=mk.init_circle(n_markers, 0.5, 0.4, 0.2, dtype,
                                                         flow.p.device))

    def make_step(dtype: torch.dtype, device):
        rho_eps = mom.calc_rho_eps(cfg.rho_gas, cfg.rho_liquid)
        device = torch.device(device)

        def step(state: IIState, t_end: float) -> IIState:
            fs, m = state.flow, state.markers
            if fs.U.dtype != dtype or fs.U.device != device:
                raise ValueError(f"step built for {dtype} on {device}, state is "
                                 f"{fs.U.dtype} on {fs.U.device}")
            dt = mom.adjust_dt(fs.U, fs.V, fs.rho_u, fs.rho_v, fs.visc, g.dx, g.dy,
                               cfg.rho_gas, cfg.rho_liquid, cfg.sigma, cfg.cfl_max, cfg.dt_max)
            dt = torch.minimum(dt, t_end - fs.t)
            fs = save_old(fs)

            # markers: sample the velocity, advect, respond, spread
            m = mk.sample_velocity(m, stencil.interp_u_center(fs.U),
                                   stencil.interp_v_center(fs.V), g)
            m = mk.advect(m, dt)
            fu, fv = mk.response_force(m, kappa, eta)
            fU, fV = mk.spread_force(m, fu, fv, g, g.shape_u, g.shape_v)

            for _ in range(cfg.num_subiter):
                U = stencil.mid_time(fs.U, fs.U_old)
                V = stencil.mid_time(fs.V, fs.V_old)
                dmomU, dmomV = mom.calc_dmomdt(U, V, fs.rho_u_old, fs.rho_v_old, fs.visc, fs.p,
                                               fs.p_jump_u, fs.p_jump_v, g.dx, g.dy, rho_eps)
                U, V = mom.update_velocity(fs.U_old, fs.V_old, fs.rho_u_old, fs.rho_v_old,
                                           fs.rho_u, fs.rho_v, dmomU + fU, dmomV + fV, dt, U, V)
                U, V = bc.apply_velocity_bcs(U, V, g, cfg.bcs, fs.t)
                div = stencil.divergence(U, V, g.dx, g.dy)
                delta_p, rel, iters = incomp.pressure_solve(fs, div, dt, g, cfg)
                U, V = incomp.project_velocity(U, V, delta_p, fs.rho_u, fs.rho_v, dt, g.dx, g.dy)
                fs = dataclasses.replace(fs, U=U, V=V, p=fs.p + delta_p, p_res=rel,
                                         p_iter=fs.p_iter + iters)
            fs = dataclasses.replace(fs, t=fs.t + dt, dt=dt)
            return IIState(flow=fs, markers=m)

        return step

    case.make_state = make_state  # type: ignore[method-assign]
    case.make_step = make_step  # type: ignore[method-assign]
    return case
