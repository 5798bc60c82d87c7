"""Simulation state: port of ``fluidsolver_tpu.solvers.state``.

``FlowState`` holds torch tensors with the JAX state's field names, shapes
and dtypes (``t``, ``dt``, ``p_res`` are 0-d float tensors, ``p_iter`` a
0-d int32 tensor). ``state_from_numpy``/``state_to_numpy`` carry a state
across the package boundary as numpy arrays.
"""

from __future__ import annotations

import dataclasses

import torch

from bench_port.reference.plain.core import fields
from bench_port.reference.plain.core.grid import Grid


def end_tolerance(dtype: torch.dtype, t_end: float) -> float:
    """Dtype-aware 'reached t_end' tolerance for the run loops.

    In f32 the accumulated time carries O(n_steps * ulp(t)) rounding error,
    so after the last intended step ``t`` can sit a few ULP short of
    ``t_end``; an absolute 1e-14 guard would then admit a 'residue step'
    whose dt is pure roundoff, and the Poisson RHS (which scales with 1/dt)
    turns f32 rounding noise into O(1) pressure junk. Must equal the
    ``clamp_dt_to_end`` snap threshold, so a remaining time above this
    tolerance is never snapped and the run loop always makes progress."""
    eps = float(torch.finfo(dtype).eps)
    return max(1e-14, 64.0 * eps * abs(float(t_end)))


def clamp_dt_to_end(dt: torch.Tensor, t: torch.Tensor, t_end: float) -> torch.Tensor:
    """min(dt, t_end - t), with sub-roundoff residues snapped to exactly
    zero; the step is a no-op at dt == 0, so the f32 residue step becomes
    that no-op."""
    remaining = t_end - t
    eps = torch.finfo(remaining.dtype).eps
    tiny = 64.0 * eps * torch.maximum(torch.full_like(t, t_end).abs(), t.abs())
    remaining = torch.where(remaining <= tiny, torch.zeros_like(remaining), remaining)
    return torch.minimum(dt, remaining)


@dataclasses.dataclass
class FlowState:
    """Staggered flow state incl. the ``old`` copy used by the subiterated
    Crank-Nicolson scheme."""

    U: torch.Tensor
    V: torch.Tensor
    rho_u: torch.Tensor
    rho_v: torch.Tensor
    U_old: torch.Tensor
    V_old: torch.Tensor
    rho_u_old: torch.Tensor
    rho_v_old: torch.Tensor
    p: torch.Tensor
    visc: torch.Tensor
    p_jump_u: torch.Tensor
    p_jump_v: torch.Tensor
    t: torch.Tensor
    dt: torch.Tensor
    p_res: torch.Tensor
    p_iter: torch.Tensor


def init_flow_state(grid: Grid, rho: float, visc: float, dtype: torch.dtype, device) -> FlowState:
    """Quiescent single-phase state."""
    z = torch.zeros((), dtype=dtype, device=device)
    return FlowState(
        U=fields.zeros_u(grid, dtype, device),
        V=fields.zeros_v(grid, dtype, device),
        rho_u=fields.full_u(grid, rho, dtype, device),
        rho_v=fields.full_v(grid, rho, dtype, device),
        U_old=fields.zeros_u(grid, dtype, device),
        V_old=fields.zeros_v(grid, dtype, device),
        rho_u_old=fields.full_u(grid, rho, dtype, device),
        rho_v_old=fields.full_v(grid, rho, dtype, device),
        p=fields.zeros_center(grid, dtype, device),
        visc=fields.full_center(grid, visc, dtype, device),
        p_jump_u=fields.zeros_u(grid, dtype, device),
        p_jump_v=fields.zeros_v(grid, dtype, device),
        t=z,
        dt=z.clone(),
        p_res=z.clone(),
        p_iter=torch.zeros((), dtype=torch.int32, device=device),
    )


def save_old(state: FlowState) -> FlowState:
    """State rotation: the current fields become the previous time level."""
    return dataclasses.replace(
        state, U_old=state.U, V_old=state.V, rho_u_old=state.rho_u, rho_v_old=state.rho_v
    )


_FIELDS = tuple(f.name for f in dataclasses.fields(FlowState))
