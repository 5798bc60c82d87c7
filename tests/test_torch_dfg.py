"""The port's DFG cylinder benchmark kit (``cases/dfg.py``) against the JAX
package on the CPU in f64: the drag, lift and pressure-difference
evaluators on the same JAX-made states to 1e-12, and the three DFG 2D-1
cases (diffuse, sharp, Luchini IB) at ny=24 for 3 steps, at a pressure
tolerance of 1e-11, held to 1e-8 relative on U, V and p as
``test_torch_ib.py`` holds the IB channels."""

import dataclasses

import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import dfg as jdfg
from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu_torch.cases import dfg, get_case, list_cases
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.ops import stencil

torch.set_num_threads(1)
CASES = ("diffuse_ib_dfg", "sharp_ib_dfg", "luchini_ib_dfg")
_RUNS = {}


def T(a):
    return torch.as_tensor(np.array(a))


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def runs(name):
    """3 steps of the case at ny=24 and tol 1e-11 in both packages (once a
    module): the JAX and port states after each step and the port's host
    syncs a step."""
    if name not in _RUNS:
        jcase, tcase = jget_case(name, ny=24), get_case(name, ny=24)
        jcase.cfg = dataclasses.replace(jcase.cfg, pressure_tol=1e-11)
        tcase.cfg = dataclasses.replace(tcase.cfg, pressure_tol=1e-11)
        jstate, jstep = jcase.make_state(np.float64), jcase.make_step()
        state, step = tcase.make_state(torch.float64, "cpu"), tcase.make_step(torch.float64, "cpu")
        out = []
        for _ in range(3):
            jstate = jstep(jstate, jcase.t_end)
            s0 = sync.count
            state = step(state, tcase.t_end)
            out.append((jstate, state, sync.count - s0))
        _RUNS[name] = (jcase, tcase, out)
    return _RUNS[name]


def test_registry_has_the_dfg_cases():
    assert set(CASES) | {"immersed_interface"} <= set(list_cases())
    assert len(list_cases()) == 21
    for name in CASES:
        case, jcase = get_case(name, ny=24), jget_case(name, ny=24)
        assert case.grid.shape_center == jcase.grid.shape_center
        assert case.cfg.ib_mode == jcase.cfg.ib_mode
        assert case.meta["Re"] == pytest.approx(jcase.meta["Re"], rel=1e-15)
    for b in (1, 2, 3):
        assert dfg.u_mean(b, 1.7) == jdfg.u_mean(b, 1.7)


@pytest.mark.parametrize("name", CASES)
def test_dfg_case_against_jax(name):
    """t, U, V, p to 1e-8 relative, the host syncs of a step 1 + p_iter +
    solves, and the divergence of both below 1e-6."""
    jcase, tcase, out = runs(name)
    for jstate, state, syncs in out:
        assert syncs == 1 + int(state.p_iter) + tcase.cfg.num_subiter
        assert float(state.t) == pytest.approx(float(jstate.t), rel=1e-14)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= 1e-8, k
    g = tcase.grid
    div = stencil.divergence(state.U, state.V, g.dx, g.dy)[1:-1, 1:-1]
    assert float(div.abs().max()) <= 1e-6


@pytest.mark.parametrize("name", ["sharp_ib_dfg", "luchini_ib_dfg"])
def test_dfg_evaluators_match_jax(name):
    """Every evaluator on the JAX package's own state after 3 steps."""
    jcase, tcase, out = runs(name)
    jstate = out[-1][0]
    jg, g = jcase.grid, tcase.grid
    um = dfg.u_mean(1, 0.0)
    p, U, V = T(jstate.p), T(jstate.U), T(jstate.V)
    pairs = [
        (dfg.calc_p_diff(p, g), jdfg.calc_p_diff(jstate.p, jg)),
        (dfg.calc_c_d(p, U, g, um), jdfg.calc_c_d(jstate.p, jstate.U, jg, um)),
        (dfg.calc_c_l(p, V, g, um), jdfg.calc_c_l(jstate.p, jstate.V, jg, um)),
        (dfg.calc_c_d_surface(p, U, V, g, um), jdfg.calc_c_d_surface(jstate.p, jstate.U, jstate.V, jg, um)),
        (dfg.calc_c_l_surface(p, U, V, g, um, n_theta=360, delta=0.01),
         jdfg.calc_c_l_surface(jstate.p, jstate.U, jstate.V, jg, um, n_theta=360, delta=0.01)),
    ]
    for k, (got, want) in enumerate(pairs):
        assert got.dtype == torch.float64 and got.shape == ()
        assert float(got) == pytest.approx(float(want), rel=1e-12, abs=1e-12), k
