"""The port's mass-source cases against the JAX package, in f64 on the
CPU: the expanding bubble (phase change in the two-phase step) and the
growing solid (a time-dependent diffuse IB and a divergence source in the
incompressible step), each 3 steps against the JAX step at a pressure
tolerance of 1e-11, and the physics checks of ``tests/test_sources.py``
on the port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu.solvers import incomp as jincomp
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync
from tests.test_torch_twophase_variants import max_rel, run_against_jax

torch.set_num_threads(1)


def test_expanding_bubble_against_jax():
    """expanding_bubble(n=24), relative to each field's largest value
    (measured in brackets): U, V, p to 1e-10 (2.6e-12), vf to 1e-9
    (7.6e-11), the interface length to 1e-11 (2.0e-13) and the curvature
    to 1e-7 (2.0e-8): a cell at vf = 0.999998 takes its plane near the
    corner, where the plane constant's square root turns rounding-level
    differences into curvature, in step 3."""
    state = run_against_jax("expanding_bubble", dict(n=24), {},
                            tols={"U": 1e-10, "V": 1e-10, "p": 1e-10, "vf": 1e-9, "curv": 1e-7,
                                  "interface_length": 1e-11})
    assert float(state.flow.t) > 0.0


def test_expanding_bubble_grows():
    """tests/test_sources.py's check on the port: n=48, m_dot=1, 25 steps;
    the gas area grows by more than 0.3 of 2 pi r m_dot t and vf stays in
    [0, 1] within 1e-8."""
    case = get_case("expanding_bubble", n=48, m_dot=1.0)
    g = case.grid
    state = case.make_state(torch.float64, "cpu")
    step = case.make_step(torch.float64, "cpu")
    gas0 = float(torch.sum(1.0 - state.vf[1:-1, 1:-1])) * g.dx * g.dy
    for _ in range(25):
        state = step(state, 1e9)
    assert not bool(torch.isnan(state.flow.U).any())
    gas1 = float(torch.sum(1.0 - state.vf[1:-1, 1:-1])) * g.dx * g.dy
    expected = 2.0 * np.pi * 0.15 * 1.0 * float(state.flow.t)
    assert gas1 - gas0 > 0.3 * expected, (gas0, gas1, expected)
    assert float(state.vf.min()) > -1e-8 and float(state.vf.max()) < 1.0 + 1e-8


def growing_ib_pair(ny, **kw):
    """The port's growing_ib step and the JAX package's, both at a pressure
    tolerance of 1e-11. The JAX case's own step closes over its config, so
    its step is rebuilt here from the case's IB builder and the same
    divergence source (fluidsolver_tpu/cases/sources.py)."""
    jcase, tcase = jget_case("growing_ib", ny=ny, **kw), get_case("growing_ib", ny=ny, **kw)
    cfg = dataclasses.replace(jcase.cfg, pressure_tol=1e-11)
    tcase.cfg = dataclasses.replace(tcase.cfg, pressure_tol=1e-11)
    fields = jcase.ib_builder(jcase.grid)
    r0, drdt = jcase.meta["r0"], jcase.meta["drdt"]

    def div_source(state, dt):
        return -fields(state).ib * (3.0 / (r0 + drdt * state.t)) * drdt

    jstep = jincomp.make_step(jcase.grid, cfg, ib=fields, div_source=div_source)
    return jcase, jstep, tcase


def test_growing_ib_against_jax():
    """growing_ib(ny=16), 3 steps: U, V, p to 1e-8 relative, the solid
    fractions (made on the device from t) to 1e-14, and the host syncs of a
    step 1 + p_iter + solves (the moving solid reads nothing back)."""
    jcase, jstep, tcase = growing_ib_pair(16)
    jstate = jcase.make_state(np.float64)
    state, step = tcase.make_state(torch.float64, "cpu"), tcase.make_step(torch.float64, "cpu")
    fields_t = tcase.ib_builder(tcase.grid, torch.float64, "cpu")
    fields_j = jcase.ib_builder(jcase.grid)
    for _ in range(3):
        jstate = jstep(jstate, jcase.t_end)
        s0 = sync.count
        state = step(state, tcase.t_end)
        assert sync.count - s0 == 1 + int(state.p_iter) + tcase.cfg.num_subiter
        assert float(state.t) == pytest.approx(float(jstate.t), rel=1e-14)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= 1e-8, k
        got, want = fields_t(state), fields_j(jstate)
        for k in ("ib", "ib_u", "ib_v"):
            assert max_rel(getattr(got, k), getattr(want, k)) <= 1e-14, k
    assert float(fields_t(state).ib.max()) == pytest.approx(1.0, abs=1e-14)


def test_growing_ib_pushes_flow_out():
    """tests/test_sources.py's check on the port: the growing solid
    displaces fluid, so the outflow exceeds the inflow by more than 0.3 of
    the volume source."""
    case = get_case("growing_ib", ny=24, r0=0.15, drdt=0.1)
    g = case.grid
    state = case.make_state(torch.float64, "cpu")
    step = case.make_step(torch.float64, "cpu")
    for _ in range(10):
        state = step(state, 1e9)
    U, rho_u = state.U.numpy(), state.rho_u.numpy()
    assert not np.any(np.isnan(U))
    inflow = float(np.sum(rho_u[1, 1:-1] * U[1, 1:-1]) * g.dy)
    outflow = float(np.sum(rho_u[-2, 1:-1] * U[-2, 1:-1]) * g.dy)
    r = case.meta["r0"] + case.meta["drdt"] * float(state.t)
    assert outflow - inflow > 0.3 * 3.0 / r * case.meta["drdt"] * np.pi * r**2
