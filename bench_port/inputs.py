"""The generator of initial conditions: a traffic file's parameters and a
seed give the fields that both the program and the reference start from.

A mix whose fields these built-in kinds cannot make brings its own
generator beside its data: ``traffic/<name>.py`` with a
``generate(traffic, config, seed, device)`` that returns an ``Inputs``;
the harness imports it by the mix's name and uses it in place of the
built-in kinds. The built-in kinds read from ``traffic/<name>.json``:

- ``drops`` (optional): liquid discs of one ``radius`` at fixed
  ``centers``, each moved by the seed by up to ``jitter`` in x and in y
  (0 in the channel's mixes: any move, even within a cell, changes the
  pressure solver's iterations and so the work);
- ``velocity``: ``{"kind": "rest"}`` (zero; the boundary conditions
  then start the flow), ``{"kind": "inflow_profile"}`` (the
  configuration's parabolic inflow on every column) or ``{"kind":
  "stream_perturbation", "modes": K, "peak": a}`` (the curl of a random
  stream function of the lowest K x K sine modes, scaled to a peak speed
  a; it vanishes on the walls and is divergence-free on the grid).

Everything is made on the device; the liquid fractions by the port's rule
(a 16 x 16 Gauss-Legendre average of the disc's indicator over each cell)
in float64, on the cells near each disc's edge.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import math
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

GAUSS_POINTS = 16
_ROWS = 64  # rows of cells averaged at once


@dataclasses.dataclass
class Inputs:
    vf0: Optional[torch.Tensor]   # (nx+2, ny+2) float64 liquid fractions, or None
    U0: torch.Tensor              # (nx+3, ny+2) float64, interior set
    V0: torch.Tensor              # (nx+2, ny+3) float64, interior set
    drops: list                   # the disc centres, for the record


def _faces(lo: float, n: int, h: float, device) -> torch.Tensor:
    """The ghosted face coordinates lo + (k - 1) h, k = 0 .. n + 2."""
    return lo + (torch.arange(-1, n + 2, dtype=torch.float64, device=device)) * h


def place_drops(spec: dict, rng: np.random.Generator) -> list:
    """The discs' centres, each moved by the seed by up to ``jitter`` in x
    and in y."""
    j = spec.get("jitter", 0.0)
    return [(cx + rng.uniform(-j, j), cy + rng.uniform(-j, j)) for cx, cy in spec["centers"]]


def disc_fractions(centres: list, radius: float, grid: dict, device) -> torch.Tensor:
    """Cell-averaged indicator of the union of the discs over the ghosted
    cell box (float64); the discs must not overlap."""
    nx, ny = grid["nx"], grid["ny"]
    dx = (grid["x_max"] - grid["x_min"]) / nx
    dy = (grid["y_max"] - grid["y_min"]) / ny
    xf = _faces(grid["x_min"], nx, dx, device)
    yf = _faces(grid["y_min"], ny, dy, device)
    pts, wts = np.polynomial.legendre.leggauss(GAUSS_POINTS)
    pts = torch.as_tensor(pts, dtype=torch.float64, device=device)
    w2 = torch.as_tensor(np.outer(wts, wts), dtype=torch.float64, device=device)
    vf = torch.zeros((nx + 2, ny + 2), dtype=torch.float64, device=device)
    xm, ym = 0.5 * (xf[:-1] + xf[1:]), 0.5 * (yf[:-1] + yf[1:])
    reach = math.hypot(dx, dy)
    for cx, cy in centres:
        d = torch.hypot(xm[:, None] - cx, ym[None, :] - cy)
        vf = torch.where(d <= radius - reach, torch.ones_like(vf), vf)
        near = ((d - radius).abs() < reach).nonzero()
        i0, i1 = int(near[:, 0].min()), int(near[:, 0].max()) + 1
        j0, j1 = int(near[:, 1].min()), int(near[:, 1].max()) + 1
        ys = 0.5 * dy * pts[None, :] + 0.5 * (yf[j0:j1] + yf[j0 + 1:j1 + 1])[:, None]
        for r in range(i0, i1, _ROWS):
            r1 = min(r + _ROWS, i1)
            xs = 0.5 * dx * pts[None, :] + 0.5 * (xf[r:r1] + xf[r + 1:r1 + 1])[:, None]
            inside = ((xs[:, None, :, None] - cx) ** 2 + (ys[None, :, None, :] - cy) ** 2
                      <= radius ** 2).to(torch.float64)
            avg = (inside * w2).sum(dim=(-2, -1)) * 0.25
            box = vf[r:r1, j0:j1]
            band = (d[r:r1, j0:j1] - radius).abs() < reach
            vf[r:r1, j0:j1] = torch.where(band, avg, box)
    return vf


def inflow_profile(grid: dict, u_avg: float, device) -> torch.Tensor:
    """U on every face of the ghosted box: the parabolic inflow of mean
    ``u_avg`` across the channel's height (y from 0)."""
    nx, ny = grid["nx"], grid["ny"]
    h = grid["y_max"] - grid["y_min"]
    dy = h / ny
    ym = grid["y_min"] + (torch.arange(-1, ny + 1, dtype=torch.float64, device=device) + 0.5) * dy
    a, b = -6.0 * u_avg / h ** 2, 6.0 * u_avg / h
    return (a * ym * ym + b * ym)[None, :].expand(nx + 3, ny + 2).clone()


def stream_perturbation(grid: dict, modes: int, peak: float, rng: np.random.Generator,
                        device) -> tuple:
    """(U, V) = curl of psi = sum a_mn sin(m pi x') sin(n pi y') over the
    box (x', y' scaled to [0, 1]), a_mn ~ N(0, 1) / (m^2 + n^2), scaled so
    that the largest speed on a face is ``peak``."""
    nx, ny = grid["nx"], grid["ny"]
    lx, ly = grid["x_max"] - grid["x_min"], grid["y_max"] - grid["y_min"]
    dx, dy = lx / nx, ly / ny
    xs = (_faces(grid["x_min"], nx, dx, device) - grid["x_min"]) / lx
    ys = (_faces(grid["y_min"], ny, dy, device) - grid["y_min"]) / ly
    k = np.arange(1, modes + 1)
    amp = rng.standard_normal((modes, modes)) / (k[:, None] ** 2 + k[None, :] ** 2)
    amp = torch.as_tensor(amp, dtype=torch.float64, device=device)
    kk = torch.as_tensor(k, dtype=torch.float64, device=device)
    sx = torch.sin(math.pi * kk[:, None] * xs[None, :])      # (K, nx+3)
    sy = torch.sin(math.pi * kk[:, None] * ys[None, :])      # (K, ny+3)
    psi = sx.T @ amp @ sy                                    # (nx+3, ny+3) at the nodes
    U = (psi[:, 1:] - psi[:, :-1]) / dy
    V = -(psi[1:, :] - psi[:-1, :]) / dx
    scale = peak / float(torch.maximum(U[1:-1, 1:-1].abs().max(), V[1:-1, 1:-1].abs().max()))
    return U * scale, V * scale


def generator(name: str, traffic_dir: Path) -> Callable:
    """The mix's own ``generate`` from ``traffic_dir/<name>.py`` where that
    file exists, else the built-in kinds' (:func:`generate`)."""
    path = traffic_dir / f"{name}.py"
    if not path.exists():
        return generate
    spec = importlib.util.spec_from_file_location(f"bench_port.traffic.{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.generate


def generate(traffic: dict, config: dict, seed: int, device) -> Inputs:
    """The initial fields of ``traffic`` on ``config``'s grid, from ``seed``,
    by the built-in kinds."""
    rng = np.random.default_rng(seed)
    grid = config["grid"]
    nx, ny = grid["nx"], grid["ny"]
    drops, vf0 = [], None
    if "drops" in traffic:
        drops = place_drops(traffic["drops"], rng)
        vf0 = disc_fractions(drops, traffic["drops"]["radius"], grid, device)
    vel = traffic["velocity"]
    if vel["kind"] == "rest":
        U0 = torch.zeros((nx + 3, ny + 2), dtype=torch.float64, device=device)
        V0 = torch.zeros((nx + 2, ny + 3), dtype=torch.float64, device=device)
    elif vel["kind"] == "inflow_profile":
        U0 = inflow_profile(grid, config["bcs"]["left"]["u"]["parabolic_mean"], device)
        V0 = torch.zeros((nx + 2, ny + 3), dtype=torch.float64, device=device)
    elif vel["kind"] == "stream_perturbation":
        U0, V0 = stream_perturbation(grid, vel["modes"], vel["peak"], rng, device)
    else:
        raise ValueError(f"unknown velocity kind {vel['kind']!r}")
    return Inputs(vf0=vf0, U0=U0, V0=V0, drops=[[float(a), float(b)] for a, b in drops])
