"""DFG 2D cylinder benchmark kit: port of ``fluidsolver_tpu.cases.dfg``
(the reference's examples/DFGBenchmarkSetup.hpp:22-413).

The Schaefer-Turek flow-around-cylinder setups (DFG 2D-1 steady, 2D-2
periodic, 2D-3 pulsed) with the drag, lift and pressure-difference
evaluators of the {DiffuseIB,SharpIB,LuchiniIB}-DFG drivers. Literature
values for 2D-1: C_D 5.57-5.59, C_L 0.0104-0.0110, dp 0.1172-0.1176. The
evaluators run on the device and return 0-d tensors.
"""

from __future__ import annotations

import math

import torch

from fluidsolver_tpu_torch.cases.registry import Case, register
from fluidsolver_tpu_torch.core import bc
from fluidsolver_tpu_torch.core.grid import Grid, make_grid
from fluidsolver_tpu_torch.ib import diffuse, luchini, sharp
from fluidsolver_tpu_torch.ib.geometry import Circle
from fluidsolver_tpu_torch.ops.stencil import sample_centered
from fluidsolver_tpu_torch.solvers.config import SolverConfig

WALL = Circle(0.2, 0.2, 0.05)
L = 2.0 * WALL.r
RHO = 1.0
VISC = 1e-3
Y_MAX = 0.41
X_MAX = 2.2


def u_mean(benchmark: int, t) -> float:
    """Mean inflow velocity (DFGBenchmarkSetup.hpp:76-86)."""
    if benchmark == 1:
        return 2.0 / 3.0 * 0.3
    if benchmark == 2:
        return 2.0 / 3.0 * 1.5
    return 2.0 / 3.0 * 1.5 * math.sin(math.pi * t / 8.0)


def reynolds(benchmark: int, t=0.0) -> float:
    return RHO * u_mean(benchmark, t) * L / VISC


def _vec(values, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(values, dtype=like.dtype, device=like.device)


def calc_p_diff(p, grid: Grid):
    """p(0.15, 0.2) - p(0.25, 0.2), the front and back stagnation pressure
    difference (DFGBenchmarkSetup.hpp:165-192), each sampled 1.5 cells
    outward along the stagnation line: a bilinear sample on the surface
    would mix in solid cells, whose pressure sharp and ghost-cell IBs leave
    unconstrained."""
    d = 1.5 * grid.dx
    xs = _vec([0.15 - d, 0.25 + d], p)
    ys = _vec([0.2, 0.2], p)
    vals = sample_centered(p, grid.xm[1], grid.dx, grid.ym[1], grid.dy, xs, ys)
    return vals[0] - vals[1]


def _floor_index(pos, origin: float, delta: float):
    # divides by a 0-d tensor: PyTorch on CUDA turns a division by a
    # Python scalar into a product with its reciprocal
    return torch.floor((pos - origin) / _vec(delta, pos)).to(torch.int64)


def calc_c_d(p, U, grid: Grid, um: float):
    """Drag coefficient by the row-wise surface-pressure and deviatoric-
    stress sum (DFGBenchmarkSetup.hpp:333-360)."""
    g = grid
    ym = _vec(g.ym[1:-1], p)
    inside = torch.abs(ym - WALL.y) <= WALL.r
    half = torch.sqrt(torch.clamp(WALL.r ** 2 - (ym - WALL.y) ** 2, min=0.0))
    i_left = _floor_index(WALL.x - half, g.x[1], g.dx)
    i_right = _floor_index(WALL.x + half, g.x[1], g.dx)
    jj = torch.arange(g.ny, device=p.device)
    p_l = p[i_left + 1, jj + 1]
    p_r = p[i_right + 1, jj + 1]
    # one-sided du/dx just outside the surface
    dudx_l = (U[i_left + 1, jj + 1] - U[i_left, jj + 1]) / g.dx
    dudx_r = (U[i_right + 2, jj + 1] - U[i_right + 1, jj + 1]) / g.dx
    contrib = ((p_l - p_r) + 2.0 * VISC * (dudx_r - dudx_l)) * g.dy
    drag = torch.sum(torch.where(inside, contrib, torch.zeros_like(contrib)))
    return 2.0 * drag / (RHO * um ** 2 * L)


def calc_c_l(p, V, grid: Grid, um: float):
    """Lift coefficient, the column-wise analog (DFGBenchmarkSetup.hpp
    :365-393)."""
    g = grid
    xm = _vec(g.xm[1:-1], p)
    inside = torch.abs(xm - WALL.x) <= WALL.r
    half = torch.sqrt(torch.clamp(WALL.r ** 2 - (xm - WALL.x) ** 2, min=0.0))
    j_bottom = _floor_index(WALL.y - half, g.y[1], g.dy)
    j_top = _floor_index(WALL.y + half, g.y[1], g.dy)
    ii = torch.arange(g.nx, device=p.device)
    p_b = p[ii + 1, j_bottom + 1]
    p_t = p[ii + 1, j_top + 1]
    dvdy_b = (V[ii + 1, j_bottom + 1] - V[ii + 1, j_bottom]) / g.dy
    dvdy_t = (V[ii + 1, j_top + 2] - V[ii + 1, j_top + 1]) / g.dy
    contrib = -((p_b - p_t) + 2.0 * VISC * (dvdy_t - dvdy_b)) * g.dx
    lift = torch.sum(torch.where(inside, contrib, torch.zeros_like(contrib)))
    return 2.0 * lift / (RHO * um ** 2 * L)


def _surface_stress(p, U, V, grid: Grid, n_theta: int, delta):
    """The traction integrated over a circle of radius r + delta around
    WALL (the full deviatoric stress, the reference's theta-integral
    variant, DFGBenchmarkSetup.hpp:300-331). Gradients are differences at
    their staggered locations (du/dx, dv/dy at centres; du/dy, dv/dx at
    nodes), each sampled bilinearly at the probe points. ``delta``
    (default 1.5 cells) keeps every bilinear stencil centre half a cell on
    the fluid side."""
    g = grid
    if delta is None:
        delta = 1.5 * min(g.dx, g.dy)
    theta = (torch.arange(n_theta, dtype=p.dtype, device=p.device) + 0.5) * (2.0 * math.pi / n_theta)
    nx_, ny_ = torch.cos(theta), torch.sin(theta)
    rs = WALL.r + delta
    px = WALL.x + rs * nx_
    py = WALL.y + rs * ny_

    # centre-located: p, du/dx, dv/dy
    dudx = (U[1:, :] - U[:-1, :]) / g.dx
    dvdy = (V[:, 1:] - V[:, :-1]) / g.dy
    p_s = sample_centered(p, g.xm[1], g.dx, g.ym[1], g.dy, px, py)
    dudx_s = sample_centered(dudx, g.xm[1], g.dx, g.ym[1], g.dy, px, py)
    dvdy_s = sample_centered(dvdy, g.xm[1], g.dx, g.ym[1], g.dy, px, py)
    # node-located: du/dy at (x[i], y[j+1]), dv/dx at (x[i+1], y[j])
    dudy = (U[:, 1:] - U[:, :-1]) / g.dy
    dvdx = (V[1:, :] - V[:-1, :]) / g.dx
    dudy_s = sample_centered(dudy, g.x[1], g.dx, g.y[2], g.dy, px, py)
    dvdx_s = sample_centered(dvdx, g.x[2], g.dx, g.y[1], g.dy, px, py)

    shear = VISC * (dudy_s + dvdx_s)
    fx = (-p_s + 2.0 * VISC * dudx_s) * nx_ + shear * ny_
    fy = shear * nx_ + (-p_s + 2.0 * VISC * dvdy_s) * ny_
    ds = rs * (2.0 * math.pi / n_theta)
    return torch.sum(fx) * ds, torch.sum(fy) * ds


def calc_c_d_surface(p, U, V, grid: Grid, um: float, n_theta: int = 720, delta=None):
    """Drag coefficient from the full surface-stress integral (with the
    skin friction the row-wise ``calc_c_d`` omits; the
    literature-comparable evaluator)."""
    fx, _ = _surface_stress(p, U, V, grid, n_theta, delta)
    return 2.0 * fx / (RHO * um ** 2 * L)


def calc_c_l_surface(p, U, V, grid: Grid, um: float, n_theta: int = 720, delta=None):
    """Lift coefficient from the full surface-stress integral."""
    _, fy = _surface_stress(p, U, V, grid, n_theta, delta)
    return 2.0 * fy / (RHO * um ** 2 * L)


def _dfg_case(name: str, ib_mode: str, ny: int, benchmark: int, scheme: str = "quadratic") -> Case:
    nx = int(ny * X_MAX / Y_MAX)
    g = make_grid(0.0, X_MAX, nx, 0.0, Y_MAX, ny)

    if benchmark == 3:
        def inflow(y, t):
            u = 1.5 * torch.sin(math.pi * t / 8.0)
            return 4.0 * u * y * (Y_MAX - y) / Y_MAX ** 2
    else:
        u_peak = 0.3 if benchmark == 1 else 1.5

        def inflow(y, t):
            return 4.0 * u_peak * y * (Y_MAX - y) / Y_MAX ** 2

    cfg = SolverConfig(
        rho_gas=RHO, rho_liquid=RHO, visc_gas=VISC, visc_liquid=VISC,
        cfl_max=0.5, dt_max=1e-2, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(
            bc.Dirichlet(u=inflow, v=0.0), bc.Neumann(clipped=True),
            bc.Dirichlet(), bc.Dirichlet(),
        ),
        outflow_correction=True,
        ib_mode=ib_mode,
    )

    def build(grid, dtype, device):
        if ib_mode == "diffuse":
            return diffuse.solid_fractions(WALL.contains, grid, dtype, device)
        if ib_mode == "sharp":
            return sharp.build(WALL, grid, dtype, device, scheme=scheme)
        return luchini.correction_fields(WALL, grid, dtype, device)

    return Case(name, g, cfg, t_end=8.0, dt_write=2e-2, ib_builder=build,
                meta=dict(wall=WALL, benchmark=benchmark, Re=reynolds(benchmark, 4.0)))


@register("diffuse_ib_dfg")
def diffuse_ib_dfg(ny: int = 64, benchmark: int = 1) -> Case:
    return _dfg_case("diffuse_ib_dfg", "diffuse", ny, benchmark)


@register("sharp_ib_dfg")
def sharp_ib_dfg(ny: int = 64, benchmark: int = 1, scheme: str = "quadratic") -> Case:
    return _dfg_case("sharp_ib_dfg", "sharp", ny, benchmark, scheme)


@register("luchini_ib_dfg")
def luchini_ib_dfg(ny: int = 64, benchmark: int = 1) -> Case:
    return _dfg_case("luchini_ib_dfg", "luchini", ny, benchmark)
