"""Mass-source cases: port of ``fluidsolver_tpu.cases.sources``.

``growing_ib``: a solid circle that grows at a prescribed rate in a
channel (examples/GrowingIB.cpp); the displaced volume enters continuity
as the divergence source -ib (3/r) dr/dt. ``expanding_bubble``: a gas
bubble that grows by an interfacial mass flux (examples/ExpandingBubble.cpp,
the two-phase step's ``phase_change_mdot``).
"""

from __future__ import annotations

import numpy as np
import torch

from fluidsolver_tpu_torch.cases.registry import Case, register
from fluidsolver_tpu_torch.core import bc
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ib.diffuse import DiffuseIB
from fluidsolver_tpu_torch.solvers import incomp
from fluidsolver_tpu_torch.solvers.config import SolverConfig
from fluidsolver_tpu_torch.vof.plic import area_fraction


@register("growing_ib")
def growing_ib(ny: int = 64, r0: float = 0.1, drdt: float = 0.1) -> Case:
    """Channel with a solid circle growing at ``drdt``; the displaced volume
    enters the continuity equation as div -= ib (3/r) drdt
    (examples/GrowingIB.cpp:93-100). The solid fractions are made on the
    device from the state's time with no host read: each cell's fraction
    is that of the half-plane through its lower-left corner normal to the
    radius, r - dist away from it (the PLIC linearization of the circle,
    exact to O(h^2))."""
    y_max, x_max = 1.0, 3.0
    nx = int(ny * x_max / y_max)
    g = make_grid(0.0, x_max, nx, 0.0, y_max, ny)
    cx, cy = 1.0, 0.5

    def inflow(y, t):
        return 4.0 * 1.0 * y * (y_max - y) / y_max**2

    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1.0, visc_gas=1e-3, visc_liquid=1e-3,
        cfl_max=0.5, dt_max=5e-3, num_subiter=3,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(
            bc.Dirichlet(u=inflow, v=0.0), bc.Neumann(clipped=True),
            bc.Dirichlet(), bc.Dirichlet(),
        ),
        outflow_correction=False,
        ib_mode="diffuse",
    )

    def radial_planes(grid, dtype, device) -> dict:
        """Per field (ib, ib_u, ib_v): the unit radius and the distance from
        the centre of each control volume's lower-left corner, on the
        device (they do not change with r)."""
        x, y = grid.x, grid.y
        corners = {
            "ib": np.meshgrid(x[:-1], y[:-1], indexing="ij"),
            "ib_u": np.meshgrid(x - grid.dx / 2, y[:-1], indexing="ij"),
            "ib_v": np.meshgrid(x[:-1], y - grid.dy / 2, indexing="ij"),
        }
        planes = {}
        for name, (X, Y) in corners.items():
            ex, ey = X - cx, Y - cy
            dist = np.sqrt(ex * ex + ey * ey)
            nrm = np.where(dist > 0.0, dist, 1.0)
            planes[name] = tuple(torch.as_tensor(a, dtype=dtype, device=device)
                                 for a in (ex / nrm, ey / nrm, dist))
        return planes

    def fraction(grid, plane, r):
        nx_, ny_, dist = plane
        return area_fraction(nx_, ny_, r - dist, grid.dx, grid.dy)

    def ib_builder(grid, dtype, device):
        """fields(state) -> DiffuseIB of the circle of radius r0 + drdt t."""
        planes = radial_planes(grid, dtype, device)

        def fields(state):
            r = r0 + drdt * state.t
            return DiffuseIB(**{k: fraction(grid, p, r) for k, p in planes.items()})

        return fields

    case = Case("growing_ib", g, cfg, t_end=2.0, dt_write=2e-2,
                ib_builder=ib_builder, meta=dict(r0=r0, drdt=drdt, cx=cx, cy=cy))

    def make_step_with_source(dtype: torch.dtype, device):
        fields = ib_builder(g, dtype, device)
        centre = radial_planes(g, dtype, device)["ib"]

        def div_source(state, dt):
            # the growing solid displaces fluid
            r = r0 + drdt * state.t
            return -fraction(g, centre, r) * (3.0 / r) * drdt

        return incomp.make_step(g, case.cfg, dtype, device, ib=fields, div_source=div_source)

    case.make_step = make_step_with_source  # type: ignore[method-assign]
    return case


@register("expanding_bubble")
def expanding_bubble(n: int = 128, m_dot: float = 0.01) -> Case:
    """Evaporating (expanding) bubble by an interfacial mass flux
    (examples/ExpandingBubble.cpp:19-60; the two-phase step's
    ``phase_change_mdot``)."""
    g = make_grid(0.0, 1.0, n, 0.0, 1.0, n)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-6, visc_liquid=1e-3,
        sigma=1.0 / 20.0, cfl_max=0.5, dt_max=1e-3, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(bc.Neumann(), bc.Neumann(), bc.Neumann(), bc.Neumann()),
        phase_change_mdot=m_dot,
    )

    def vf0(x, y):
        # a gas bubble (vf = 0) in the middle of the liquid
        return ~((x - 0.5) ** 2 + (y - 0.5) ** 2 <= 0.15**2)

    return Case("expanding_bubble", g, cfg, t_end=0.5, dt_write=5e-3,
                vf0=vf0, two_phase=True, meta=dict(m_dot=m_dot))
