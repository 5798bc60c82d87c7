"""Case registry: port of the single-phase and two-phase cases of
``fluidsolver_tpu.cases.registry``.

Each case function returns a ``Case`` bundling grid, config and initial
condition; ``make_state(dtype, device)`` builds the initial state (a
``FlowState``, or a ``TwoPhaseState`` for a two-phase case) and
``make_step(dtype, device)`` the step function: the case's own
``step_builder`` where it has one (``vof_tgv``, the kinematic VOF step),
else the incompressible step (with the IB fields of ``ib_builder``) or the
two-phase step. ``cases/sources.py`` adds the growing solid and the
expanding bubble, ``cases/dfg.py`` the three DFG cylinder cases and
``cases/immersed_interface.py`` the marker ring.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from fluidsolver_tpu_torch.core import bc
from fluidsolver_tpu_torch.core.grid import Grid, make_grid
from fluidsolver_tpu_torch.ib import diffuse, luchini, sharp
from fluidsolver_tpu_torch.ib.geometry import Circle
from fluidsolver_tpu_torch.solvers import incomp, twophase
from fluidsolver_tpu_torch.solvers.config import SolverConfig
from fluidsolver_tpu_torch.solvers.state import init_flow_state
from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator


@dataclasses.dataclass
class Case:
    name: str
    grid: Grid
    cfg: SolverConfig
    t_end: float
    dt_write: float
    # liquid indicator vf0(x, y) on numpy coordinate arrays (two-phase only)
    vf0: Optional[Callable] = None
    u0: Optional[Callable] = None   # u0(x, y) on numpy coordinate arrays
    v0: Optional[Callable] = None
    two_phase: bool = False
    # builds the IB fields of cfg.ib_mode: (grid, dtype, device) -> fields
    # on the device (once per make_step)
    ib_builder: Optional[Callable] = None
    # custom step factory (grid, cfg, dtype, device) -> step(state, t_end);
    # used by kinematic cases (VOF-only advection with a prescribed
    # velocity, examples/VOF.cpp) that bypass the momentum/pressure solvers
    step_builder: Optional[Callable] = None
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def make_state(self, dtype: torch.dtype, device):
        g, cfg = self.grid, self.cfg
        if self.two_phase:
            vf0 = liquid_fraction_from_indicator(self.vf0, g)
            state = twophase.init_two_phase_state(g, cfg, vf0, dtype, device)
            flow = state.flow
        else:
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
        flow = dataclasses.replace(flow, U=U, V=V)
        if self.two_phase:
            return dataclasses.replace(state, flow=flow)
        return flow

    def make_step(self, dtype: torch.dtype, device) -> Callable:
        if self.step_builder is not None:
            return self.step_builder(self.grid, self.cfg, dtype, device)
        if self.two_phase:
            return twophase.make_step(self.grid, self.cfg, dtype, device)
        ib = self.ib_builder(self.grid, dtype, device) if self.ib_builder is not None else None
        return incomp.make_step(self.grid, self.cfg, dtype, device, ib=ib)


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


# ---- immersed-boundary channels (examples/{DiffuseIB,SharpIB,IB-Luchini}.cpp) ----
def _ib_channel_base(ny: int, ib_mode: str) -> tuple:
    y_max = 1.0
    x_max = 5.0
    nx = int(ny * x_max / y_max)
    g = make_grid(0.0, x_max, nx, 0.0, y_max, ny)

    def inflow(y, t):
        return 4.0 * 1.5 * y * (y_max - y) / y_max**2

    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1.0, visc_gas=1e-3, visc_liquid=1e-3,
        cfl_max=0.5, dt_max=1e-2, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(
            bc.Dirichlet(u=inflow, v=0.0), bc.Neumann(clipped=True),
            bc.Dirichlet(), bc.Dirichlet(),
        ),
        outflow_correction=True,
        ib_mode=ib_mode,
    )
    return g, cfg


IB_WALL = Circle(1.0, 0.5, 0.15)


@register("diffuse_ib_channel")
def diffuse_ib_channel(ny: int = 128) -> Case:
    """Channel with a circular obstacle, diffuse volume-penalty forcing
    (examples/DiffuseIB.cpp: circle (1.0, 0.5, r=0.15))."""
    g, cfg = _ib_channel_base(ny, "diffuse")

    def build(grid, dtype, device):
        return diffuse.solid_fractions(IB_WALL.contains, grid, dtype, device)

    return Case("diffuse_ib_channel", g, cfg, t_end=5.0, dt_write=5e-2,
                ib_builder=build, meta=dict(wall=IB_WALL))


@register("sharp_ib_channel")
def sharp_ib_channel(ny: int = 128, scheme: str = "linear") -> Case:
    """Channel with a circular obstacle, sharp ghost-cell extrapolation
    (examples/SharpIB.cpp)."""
    g, cfg = _ib_channel_base(ny, "sharp")

    def build(grid, dtype, device):
        return sharp.build(IB_WALL, grid, dtype, device, scheme=scheme)

    return Case("sharp_ib_channel", g, cfg, t_end=5.0, dt_write=5e-2,
                ib_builder=build, meta=dict(wall=IB_WALL))


@register("luchini_ib_channel")
def luchini_ib_channel(ny: int = 128, implicit: bool = False) -> Case:
    """Channel with a circular obstacle, Luchini second-order IB
    (examples/IB-Luchini.cpp)."""
    g, cfg = _ib_channel_base(ny, "luchini_implicit" if implicit else "luchini")

    def build(grid, dtype, device):
        return luchini.correction_fields(IB_WALL, grid, dtype, device)

    return Case("luchini_ib_channel", g, cfg, t_end=5.0, dt_write=5e-2,
                ib_builder=build, meta=dict(wall=IB_WALL))


# ---- two-phase cases ----------------------------------------------------------
@register("two_phase_channel")
def two_phase_channel(ny: int = 128) -> Case:
    """Drop in channel, the canonical case (examples/TwoPhaseSolver.cpp:19-84)."""
    nx = 5 * ny
    y_max = 0.41
    g = make_grid(0.0, 2.2, nx, 0.0, y_max, ny)
    u_avg = 0.5

    def inflow(y, t):
        a = -6.0 * u_avg / y_max**2
        b = 6.0 * u_avg / y_max
        return a * y * y + b * y

    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-6, visc_liquid=1e-3,
        sigma=1.0 / 200.0, cfl_max=0.9, dt_max=1e-2, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(
            bc.Dirichlet(u=inflow, v=0.0), bc.Neumann(),
            bc.Dirichlet(), bc.Dirichlet(),
        ),
        outflow_correction=True,
    )

    def vf0(x, y):
        return (x - 0.2) ** 2 + (y - 0.2) ** 2 <= 0.05**2

    meta = dict(
        We=1e3 * u_avg**2 * 0.1 * 200.0,
        Re_L=1e3 * u_avg * y_max / 1e-3,
        Re_G=1.0 * u_avg * y_max / 1e-6,
    )
    return Case("two_phase_channel", g, cfg, t_end=2.0, dt_write=1e-2,
                vf0=vf0, two_phase=True, meta=meta)


@register("vof_tgv")
def vof_tgv(n: int = 256, visc: float = 1e-3, rho: float = 0.9) -> Case:
    """Kinematic VOF demo: four circles advected through the analytic
    decaying Taylor-Green field, velocity re-prescribed each step; no
    momentum/pressure solve (examples/VOF.cpp:40-120)."""
    g = make_grid(0.0, 2 * math.pi, n, 0.0, 2 * math.pi, n)
    per = bc.Periodic()
    cfg = SolverConfig(
        rho_gas=rho, rho_liquid=rho, visc_gas=visc, visc_liquid=visc,
        cfl_max=0.5, dt_max=1e-2,
        bcs=bc.FlowBCs(per, per, per, per),
    )

    centers = [
        (0.75 * math.pi, 0.5 * math.pi), (1.75 * math.pi, 0.5 * math.pi),
        (0.75 * math.pi, 1.5 * math.pi), (1.75 * math.pi, 1.5 * math.pi),
    ]

    def vf0(x, y):
        inside = False
        for cx, cy in centers:
            inside = inside | ((x - cx) ** 2 + (y - cy) ** 2 <= 0.25**2)
        return inside

    def step_builder(grid, cfg, dtype, device):
        # the separable field's two products, formed once on the device from
        # the 1D coordinates; a step scales them by exp(-2 visc/rho t),
        # computed from the time tensor without a host read
        def coord(a):
            return torch.as_tensor(a, dtype=dtype, device=device)

        sin_cos = torch.outer(coord(np.sin(grid.x)), coord(np.cos(grid.ym)))
        cos_sin = -torch.outer(coord(np.cos(grid.xm)), coord(np.sin(grid.y)))

        def velocity(t):
            F = torch.exp(-2.0 * visc / rho * t)
            return sin_cos * F, cos_sin * F

        return twophase.make_kinematic_step(grid, cfg, velocity, dtype, device)

    return Case("vof_tgv", g, cfg, t_end=30.0, dt_write=5e-2,
                vf0=vf0, two_phase=True, step_builder=step_builder)


@register("stationary_drop")
def stationary_drop(n: int = 64) -> Case:
    """Elliptical drop, surface tension only (test/StationaryDrop.cpp:24-73)."""
    g = make_grid(0.0, 1.0, n, 0.0, 1.0, n)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-3, visc_liquid=1e-3,
        sigma=1.0 / 20.0, cfl_max=0.5, dt_max=1e-1, num_subiter=3,
        pressure_tol=1e-6, pressure_max_iter=50, pressure_pin="right",
        bcs=bc.FlowBCs(bc.Neumann(), bc.Neumann(), bc.Neumann(), bc.Neumann()),
    )

    def vf0(x, y):
        return (2.0 * (x - 0.5)) ** 2 + (y - 0.5) ** 2 <= 0.25**2

    return Case("stationary_drop", g, cfg, t_end=60.0, dt_write=1e-1,
                vf0=vf0, two_phase=True)


@register("rising_bubble")
def rising_bubble(nx: int = 128, bubble_config: int = 0) -> Case:
    """Buoyant bubble with water/hydrogen-like properties
    (examples/RisingBubble.cpp:60-124). bubble_config: 0 single, 1 side by
    side, 2 stacked."""
    r0 = 5.6e-4
    g = make_grid(-5.0 * r0, 5.0 * r0, nx, 0.0, 20.0 * r0, 2 * nx)
    gravity = -9.80665
    sigma = 0.072
    rho_l, rho_g = 1e3, 9e-2
    visc_l, visc_g = 1.002e-3, 8.8e-4
    cfg = SolverConfig(
        rho_gas=rho_g, rho_liquid=rho_l, visc_gas=visc_g, visc_liquid=visc_l,
        sigma=sigma, cfl_max=0.25, dt_max=1e-6, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=100,
        gravity=(0.0, gravity),
        bcs=bc.FlowBCs(
            bc.Neumann(), bc.Neumann(),
            bc.Dirichlet(u=0.0, v=0.0), bc.Neumann(),
        ),
    )
    cx, cy = 0.0, 2.0 * r0

    def vf0(x, y):
        # the bubble is the GAS phase: vf (liquid fraction) is its complement
        if bubble_config == 1:
            inside = ((x - cx - 1.5 * r0) ** 2 + (y - cy) ** 2 <= r0**2) | (
                (x - cx + 1.5 * r0) ** 2 + (y - cy) ** 2 <= r0**2
            )
        elif bubble_config == 2:
            inside = ((x - cx) ** 2 + (y - cy) ** 2 <= r0**2) | (
                (x - cx) ** 2 + (y - cy - 3.0 * r0) ** 2 <= r0**2
            )
        else:
            inside = (x - cx) ** 2 + (y - cy) ** 2 <= r0**2
        return ~inside

    L = 2.0 * r0
    meta = dict(
        L=L,
        Eo=rho_l * abs(gravity) * L**2 / sigma,
        Ga=abs(gravity) * L**3 * rho_l**2 / visc_l**2,
        Mo=abs(gravity) * visc_g**4 / (rho_l * sigma**3),
        rho_ratio=rho_l / rho_g,
        visc_ratio=visc_l / visc_g,
        U_inf=math.sqrt(abs(gravity) * L),
    )
    return Case("rising_bubble", g, cfg, t_end=1e-2, dt_write=1e-4,
                vf0=vf0, two_phase=True, meta=meta)


@register("wave")
def wave(ny: int = 128) -> Case:
    """Gravity wave from a Gaussian hump (examples/Wave.cpp)."""
    g = make_grid(0.0, 5.0, 5 * ny, 0.0, 1.0, ny)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-6, visc_liquid=1e-3,
        sigma=1.0 / 20.0, cfl_max=0.5, dt_max=5e-4, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        gravity=(0.0, -1.0),
        bcs=bc.FlowBCs(bc.Dirichlet(), bc.Dirichlet(), bc.Dirichlet(), bc.Dirichlet()),
    )

    def vf0(x, y):
        return y < 0.9 * np.exp(-(((x - 2.5) / 0.5) ** 2))

    return Case("wave", g, cfg, t_end=30.0, dt_write=5e-2, vf0=vf0, two_phase=True)


@register("capillary_wave")
def capillary_wave(ny: int = 64) -> Case:
    """Sinusoidal interface relaxing under surface tension
    (examples/CapillaryWave.cpp)."""
    g = make_grid(0.0, 2.0 * math.pi, ny + ny // 2, -2.0, 2.0, ny)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-6, visc_liquid=1e-3,
        sigma=1.0 / 20.0, cfl_max=0.25, dt_max=1e-4, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(bc.Periodic(), bc.Periodic(), bc.Dirichlet(), bc.Dirichlet()),
    )

    def vf0(x, y):
        return y < np.sin(x)

    return Case("capillary_wave", g, cfg, t_end=2.0, dt_write=1e-2, vf0=vf0, two_phase=True)


@register("channel_with_drop")
def channel_with_drop(ny: int = 128) -> Case:
    """Drop carried through a channel (examples/ChannelWithDrop.cpp)."""
    g = make_grid(0.0, 5.0, 5 * ny, -0.5, 0.5, ny)
    u_avg = 1.0

    def inflow(y, t):
        return -6.0 * u_avg * (y + 0.5) * (y - 0.5)

    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-6, visc_liquid=1e-3,
        sigma=1.0 / 20.0, cfl_max=0.5, dt_max=1e-2, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(
            bc.Dirichlet(u=inflow, v=0.0), bc.Neumann(),
            bc.Dirichlet(), bc.Dirichlet(),
        ),
        outflow_correction=True,
    )

    def vf0(x, y):
        return (x - 1.0) ** 2 + y**2 <= 0.15**2

    def u0(x, y):
        return -6.0 * u_avg * (y + 0.5) * (y - 0.5)

    return Case("channel_with_drop", g, cfg, t_end=2.5, dt_write=1e-2,
                vf0=vf0, u0=u0, two_phase=True)


@register("wall_bubble")
def wall_bubble(ny: int = 128) -> Case:
    """Bubble attached to the bottom wall in a fast channel
    (examples/WallBubble.cpp)."""
    g = make_grid(0.0, 5.0, 5 * ny, 0.0, 1.0, ny)
    u_avg = 5.0

    def inflow(y, t):
        a = -6.0 * u_avg
        b = 6.0 * u_avg
        return a * y * y + b * y

    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-6, visc_liquid=1e-3,
        sigma=1.0 / 20.0, cfl_max=0.9, dt_max=1e-2, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(
            bc.Dirichlet(u=inflow, v=0.0), bc.Neumann(clipped=True),
            bc.Dirichlet(), bc.Dirichlet(),
        ),
        outflow_correction=True,
    )

    def vf0(x, y):
        return (x - 1.0) ** 2 + (y - 0.0) ** 2 <= 0.25**2

    we = 1e3 * u_avg**2 * 0.5 * 20.0
    meta = dict(We=we, Re_L=1e3 * u_avg / 1e-3, Oh=math.sqrt(we) / (1e3 * u_avg / 1e-3))
    return Case("wall_bubble", g, cfg, t_end=2.0, dt_write=1e-2, vf0=vf0,
                two_phase=True, meta=meta)


@register("slow_channel")
def slow_channel(level: int = 6) -> Case:
    """Nondimensionalized creeping channel with a drop
    (examples/SlowChannel.cpp: Re = We = 1e-3, ratios 1000)."""
    Re, We = 1e-3, 1e-3
    L = 2.0
    D = 0.25 * L
    rho_l, mu_l = 1.0, 1e-3
    u_mean = Re * mu_l / (rho_l * D)
    sigma = rho_l * u_mean**2 * D / We
    n = 1 << level
    g = make_grid(0.0, L, n, 0.0, L, n)

    def inflow(y, t):
        return -6.0 * u_mean / L**2 * y * (y - L)

    t_end = L / (2.0 * 1.5 * u_mean)
    cfg = SolverConfig(
        rho_gas=rho_l / 1000.0, rho_liquid=rho_l,
        visc_gas=mu_l / 1000.0, visc_liquid=mu_l,
        sigma=sigma, cfl_max=0.9, dt_max=t_end / 100.0, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(
            bc.Dirichlet(u=inflow, v=0.0), bc.Neumann(),
            bc.Dirichlet(), bc.Dirichlet(),
        ),
        outflow_correction=True,
    )

    def vf0(x, y):
        return (x - 3.0 * L / 8.0) ** 2 + (y - L / 2.0) ** 2 <= (D / 2.0) ** 2

    meta = dict(Ca=mu_l * u_mean / sigma, La=sigma * rho_l * D / mu_l**2)
    return Case("slow_channel", g, cfg, t_end=t_end, dt_write=t_end / 100.0,
                vf0=vf0, two_phase=True, meta=meta)
