"""The system under test, as the benchmark drives it: the port's
``driver.Simulation`` over the configuration's registry case, started
from the benchmark's own initial fields.

This is the only module of the benchmark that imports the port.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from bench_port.inputs import Inputs

def build_kernels() -> None:
    """Build (first run in a checkout) or load the port's kernel library."""
    from fluidsolver_tpu_torch.poisson import _kernels

    _kernels.lib()


def make_case(config: dict, cfg_overrides: Optional[dict] = None):
    """The registry case of ``config``, checked against the file: its grid,
    end time and every solver key the file states."""
    from fluidsolver_tpu_torch.cases import get_case

    case = get_case(config["case"], **config["case_params"])
    g = case.grid
    stated = {k: getattr(g, k) for k in config["grid"]}
    stated["t_end"] = case.t_end
    for key, value in config["solver"].items():
        got = getattr(case.cfg, key)
        stated[key] = list(got) if isinstance(got, tuple) else got
    want = dict(config["grid"], t_end=config["t_end"], **config["solver"])
    if stated != want:
        diff = {k: (stated.get(k), want[k]) for k in want if stated.get(k) != want[k]}
        raise ValueError(f"the port's case {config['case']!r} departs from "
                         f"configs/{config['name']}.json (port, file): {diff}")
    if cfg_overrides:
        case = dataclasses.replace(case, cfg=dataclasses.replace(case.cfg, **cfg_overrides))
    return case


def initial_state(case, inputs: Inputs, dtype: torch.dtype, device):
    """The case's state at rest with the benchmark's fields, as
    ``Case.make_state`` builds it from its own: the two-phase state of the
    liquid fractions, the velocity's interior, then the velocity BCs."""
    from fluidsolver_tpu_torch.core import bc
    from fluidsolver_tpu_torch.solvers import twophase
    from fluidsolver_tpu_torch.solvers.state import init_flow_state

    g, cfg = case.grid, case.cfg
    if case.two_phase:
        state = twophase.init_two_phase_state(g, cfg, inputs.vf0.cpu().numpy(), dtype, device)
        flow = state.flow
    else:
        flow = init_flow_state(g, cfg.rho_gas, cfg.visc_gas, dtype, device)
    U, V = flow.U.clone(), flow.V.clone()
    U[1:-1, 1:-1] = inputs.U0[1:-1, 1:-1].to(dtype)
    V[1:-1, 1:-1] = inputs.V0[1:-1, 1:-1].to(dtype)
    U, V = bc.apply_velocity_bcs(U, V, g, cfg.bcs, t=0.0)
    flow = dataclasses.replace(flow, U=U, V=V)
    return dataclasses.replace(state, flow=flow) if case.two_phase else flow


def make_simulation(case, inputs: Inputs, dtype: torch.dtype, device):
    """``Simulation(save_output=False)`` over ``case``, started from
    ``inputs``; ``case.make_step`` builds the step as for any run."""
    from fluidsolver_tpu_torch.driver import Simulation

    case = dataclasses.replace(case)
    case.make_state = lambda dt, dev: initial_state(case, inputs, dt, dev)
    return Simulation(case, dtype=dtype, device=device, save_output=False,
                      warn_nonconverged=False)


def sync_count() -> int:
    """The port's count of device-draining host reads (``core.sync``)."""
    from fluidsolver_tpu_torch.core import sync

    return sync.count


def state_fields(state) -> dict:
    """A state as {name: tensor}, the flow fields under ``flow``."""
    out = {f.name: getattr(state, f.name) for f in dataclasses.fields(state)}
    if "flow" in out:
        out["flow"] = state_fields(out["flow"])
    return out


def clone_state(state):
    """A copy of a state with every tensor cloned."""
    kw = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        kw[f.name] = clone_state(v) if dataclasses.is_dataclass(v) else v.clone()
    return type(state)(**kw)


def copy_state(dst, src) -> None:
    """Copy every tensor of the state ``src`` into the same-shaped ``dst``."""
    for f in dataclasses.fields(src):
        a, b = getattr(dst, f.name), getattr(src, f.name)
        if dataclasses.is_dataclass(b):
            copy_state(a, b)
        else:
            a.copy_(b)


def active_cells(state) -> Optional[int]:
    """The sparse advection's active set of a two-phase state (cells it
    gives lanes, ``vof.advect.classify``); None for one phase. One host
    read."""
    if not hasattr(state, "vf"):
        return None
    from fluidsolver_tpu_torch.vof import advect

    all_gas, all_liq = advect.classify(state.vf)
    return int((~(all_gas | all_liq)).sum())


def lane_budget(grid) -> int:
    from fluidsolver_tpu_torch.vof import advect

    return advect.default_max_active(grid.nx, grid.ny)
