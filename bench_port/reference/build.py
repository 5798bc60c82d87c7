"""The reference's side of a cell: its grid, solver settings, initial
state and step, worked out from the configuration file and the
benchmark's initial fields alone."""

from __future__ import annotations

import dataclasses
import typing

import torch

from bench_port.inputs import Inputs
from bench_port.reference.plain.core import bc
from bench_port.reference.plain.core.grid import Grid, make_grid
from bench_port.reference.plain.solvers import incomp, twophase
from bench_port.reference.plain.solvers.config import SolverConfig
from bench_port.reference.plain.solvers.state import FlowState, init_flow_state


def _parabolic(u_avg: float, height: float):
    a = -6.0 * u_avg / height ** 2
    b = 6.0 * u_avg / height

    def inflow(y, t):
        return a * y * y + b * y

    return inflow


def _side(spec: dict, height: float):
    """A side's boundary condition: the class of ``bc`` named by ``type``
    (``Dirichlet``, ``Neumann``, ``Periodic``, ``Symmetry``) with the
    file's other keys as its fields; a value ``{"parabolic_mean": m}`` is
    the parabolic inflow of mean m across the height."""
    kinds = {cls.__name__: cls for cls in typing.get_args(bc.BCType)}
    if spec["type"] not in kinds:
        raise ValueError(f"the reference has no boundary condition {spec['type']!r}")
    fields = {k: _parabolic(v["parabolic_mean"], height) if isinstance(v, dict) else v
              for k, v in spec.items() if k != "type"}
    return kinds[spec["type"]](**fields)


def grid_and_cfg(config: dict) -> tuple:
    g = config["grid"]
    grid = make_grid(g["x_min"], g["x_max"], g["nx"], g["y_min"], g["y_max"], g["ny"])
    height = g["y_max"] - g["y_min"]
    sides = {k: _side(v, height) for k, v in config["bcs"].items()}
    solver = dict(config["solver"])
    if "gravity" in solver:
        solver["gravity"] = tuple(solver["gravity"])
    return grid, SolverConfig(bcs=bc.FlowBCs(**sides), **solver)


def initial_state(config: dict, inputs: Inputs, dtype: torch.dtype, device):
    grid, cfg = grid_and_cfg(config)
    if inputs.vf0 is not None:
        state = twophase.init_two_phase_state(grid, cfg, inputs.vf0.cpu().numpy(), dtype,
                                             device)
        flow = state.flow
    else:
        flow = init_flow_state(grid, cfg.rho_gas, cfg.visc_gas, dtype, device)
    U, V = flow.U.clone(), flow.V.clone()
    U[1:-1, 1:-1] = inputs.U0[1:-1, 1:-1].to(dtype)
    V[1:-1, 1:-1] = inputs.V0[1:-1, 1:-1].to(dtype)
    U, V = bc.apply_velocity_bcs(U, V, grid, cfg.bcs, t=0.0)
    flow = dataclasses.replace(flow, U=U, V=V)
    return dataclasses.replace(state, flow=flow) if inputs.vf0 is not None else flow


def state_from(fields: dict):
    """A reference state from {name: tensor} (the flow's under ``flow``),
    taking the reference's own field names."""
    flow = FlowState(**{f.name: fields["flow"][f.name] if "flow" in fields else fields[f.name]
                        for f in dataclasses.fields(FlowState)})
    if "flow" not in fields:
        return flow
    return twophase.TwoPhaseState(flow=flow, **{
        f.name: fields[f.name] for f in dataclasses.fields(twophase.TwoPhaseState)
        if f.name != "flow"})


def make_step(config: dict, dtype: torch.dtype, device):
    grid, cfg = grid_and_cfg(config)
    two_phase = config["two_phase"]
    step = (twophase.make_step if two_phase else incomp.make_step)(grid, cfg, dtype, device)
    return lambda state: step(state, config["t_end"])


def grid_of(config: dict) -> Grid:
    return grid_and_cfg(config)[0]
