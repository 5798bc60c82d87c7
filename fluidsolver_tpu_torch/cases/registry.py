"""Case registry: port of the single-phase cases of
``fluidsolver_tpu.cases.registry``.

Each case function returns a ``Case`` bundling grid, config and initial
condition; ``make_state(dtype, device)`` builds the initial state and
``make_step(dtype, device)`` the step function.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from fluidsolver_tpu_torch.core import bc
from fluidsolver_tpu_torch.core.grid import Grid, make_grid
from fluidsolver_tpu_torch.solvers import incomp
from fluidsolver_tpu_torch.solvers.config import SolverConfig
from fluidsolver_tpu_torch.solvers.state import FlowState, init_flow_state


@dataclasses.dataclass
class Case:
    name: str
    grid: Grid
    cfg: SolverConfig
    t_end: float
    dt_write: float
    u0: Optional[Callable] = None   # u0(x, y) on numpy coordinate arrays
    v0: Optional[Callable] = None

    def make_state(self, dtype: torch.dtype, device) -> FlowState:
        g, cfg = self.grid, self.cfg
        flow = init_flow_state(g, cfg.rho_gas, cfg.visc_gas, dtype, device)
        U, V = flow.U, flow.V
        if self.u0 is not None:
            X, Y = np.meshgrid(g.x, g.ym, indexing="ij")
            U = U.clone()
            U[1:-1, 1:-1] = torch.as_tensor(self.u0(X, Y), dtype=dtype, device=device)[1:-1, 1:-1]
        if self.v0 is not None:
            X, Y = np.meshgrid(g.xm, g.y, indexing="ij")
            V = V.clone()
            V[1:-1, 1:-1] = torch.as_tensor(self.v0(X, Y), dtype=dtype, device=device)[1:-1, 1:-1]
        U, V = bc.apply_velocity_bcs(U, V, g, cfg.bcs, t=0.0)
        return dataclasses.replace(flow, U=U, V=V)

    def make_step(self, dtype: torch.dtype, device) -> Callable:
        return incomp.make_step(self.grid, self.cfg, dtype, device)


_REGISTRY: Dict[str, Callable[..., Case]] = {}


def register(name):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn

    return deco


def get_case(name: str, **kwargs) -> Case:
    return _REGISTRY[name](**kwargs)


def list_cases():
    return sorted(_REGISTRY)


@register("incomp_channel")
def incomp_channel(ny: int = 64) -> Case:
    """Pulsed-inflow channel (examples/IncompSolver.cpp:19-60)."""
    y_max = 0.41
    x_max = 2.2
    nx = int(ny * x_max / y_max)
    g = make_grid(0.0, x_max, nx, 0.0, y_max, ny)

    def inflow(y, t):
        u = 1.5 * torch.sin(math.pi * t / 8.0)
        return 4.0 * u * y * (y_max - y) / y_max**2

    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1.0, visc_gas=1e-3, visc_liquid=1e-3,
        cfl_max=0.9, dt_max=1e-2, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(
            bc.Dirichlet(u=inflow, v=0.0), bc.Neumann(),
            bc.Dirichlet(), bc.Dirichlet(),
        ),
        outflow_correction=True,
    )
    return Case("incomp_channel", g, cfg, t_end=8.0, dt_write=5e-2)


@register("lid_driven")
def lid_driven(n: int = 129, u_lid: float = 1.0, visc: float = 1e-2) -> Case:
    """Lid-driven cavity (scaling/LidDrivenFlow.cpp)."""
    g = make_grid(0.0, 1.0, n, 0.0, 1.0, n)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1.0, visc_gas=visc, visc_liquid=visc,
        cfl_max=0.9, dt_max=1e-2, num_subiter=2,
        pressure_tol=1e-6, pressure_max_iter=100,
        bcs=bc.FlowBCs(
            bc.Dirichlet(), bc.Dirichlet(), bc.Dirichlet(),
            bc.Dirichlet(u=u_lid, v=0.0),
        ),
    )
    return Case("lid_driven", g, cfg, t_end=10.0, dt_write=1e-1)


@register("taylor_green")
def taylor_green(n: int = 128, visc: float = 0.1, rho: float = 0.9) -> Case:
    """Decaying vortex (test/TaylorGreenVortex.cpp:18-53)."""
    g = make_grid(0.0, 2 * math.pi, n, 0.0, 2 * math.pi, n)
    per = bc.Periodic()
    cfg = SolverConfig(
        rho_gas=rho, rho_liquid=rho, visc_gas=visc, visc_liquid=visc,
        cfl_max=0.5, dt_max=1e-2, num_subiter=2,
        pressure_tol=1e-6, pressure_max_iter=500,
        bcs=bc.FlowBCs(per, per, per, per),
    )

    def u0(x, y):
        return np.sin(x) * np.cos(y)

    def v0(x, y):
        return -np.cos(x) * np.sin(y)

    return Case("taylor_green", g, cfg, t_end=5.0, dt_write=1e-2, u0=u0, v0=v0)
