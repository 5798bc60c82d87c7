"""The port's two-phase VOF step against the JAX package, in f64 on the
CPU, where every kernel module runs its plain PyTorch twin.

Both packages solve with the same BoxMG hierarchy (the dense coarsest
inverse in f64), so the steps agree to rounding: the golden drop (tol
1e-10) and the channel are held to 1e-12 relative on U, V, p, vf and curv,
the bound of ``test_torch_slice.py``, and the channel's PCG iterations are
equal.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
from fluidsolver_tpu_torch.solvers import twophase
from fluidsolver_tpu_torch.solvers.config import config_from_jax
from tests.golden_cases import two_phase_drop

torch.set_num_threads(1)
TOL = 1e-12


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def test_golden_two_phase_drop():
    """twophase.run on the golden drop (64^2, 15 steps of dt_max, 1000:1,
    sigma 0.02, gravity, pinned pressure, tol 1e-10) against the committed
    f64 trajectory. The JAX case's own initial state, grid and config are
    carried across as numpy arrays."""
    jrun = two_phase_drop(np.float64)
    case = inspect.getclosurevars(jrun).nonlocals
    jg = case["g"]
    grid = make_grid(jg.x_min, jg.x_max, jg.nx, jg.y_min, jg.y_max, jg.ny)
    state = twophase.two_phase_state_from_numpy(case["state"], "cpu")
    out = twophase.run(state, case["t_end"], grid, config_from_jax(case["cfg"]))
    gold = dict(np.load("tests/goldens/two_phase_drop.npz"))
    assert float(out.flow.t) == pytest.approx(float(gold["t"]), abs=1e-14)
    got = {"U": out.flow.U, "V": out.flow.V, "p": out.flow.p, "vf": out.vf, "curv": out.curv}
    for k, v in got.items():
        assert max_rel(v, gold[k]) <= TOL, (k, max_rel(v, gold[k]))
    assert 0.0 <= float(out.vof_vol_error) < 1e-12


@pytest.mark.parametrize("refresh", ["solve", "step"])
def test_two_phase_channel_against_jax(refresh):
    """two_phase_channel(ny=16), 3 steps, step by step against the JAX
    step: callable inflow, outflow correction, 5 subiterations with a loose
    intermediate tolerance, and both hierarchy refresh policies."""
    kw = dict(pressure_tol=1e-11, pressure_tol_intermediate=1e-9,
              pressure_precond_refresh=refresh)
    jcase, tcase = jget_case("two_phase_channel", ny=16), get_case("two_phase_channel", ny=16)
    jcase.cfg = dataclasses.replace(jcase.cfg, **kw)
    tcase.cfg = dataclasses.replace(tcase.cfg, **kw)
    jstate, jstep = jcase.make_state(np.float64), jcase.make_step()
    state, step = tcase.make_state(torch.float64, "cpu"), tcase.make_step(torch.float64, "cpu")
    for _ in range(3):
        jstate = jstep(jstate, jcase.t_end)
        s0 = sync.count
        state = step(state, tcase.t_end)
        # dt > 0, then one exit test per PCG iteration and one per solve
        assert sync.count - s0 == 1 + int(state.flow.p_iter) + tcase.cfg.num_subiter
        assert float(state.flow.t) == pytest.approx(float(jstate.flow.t), rel=1e-14)
        assert int(state.flow.p_iter) == int(jstate.flow.p_iter)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state.flow, k), getattr(jstate.flow, k)) <= TOL, (k, max_rel(getattr(state.flow, k), getattr(jstate.flow, k)))
        for k in ("vf", "curv", "interface_length"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= TOL, (k, max_rel(getattr(state, k), getattr(jstate, k)))
        assert float(state.vof_vol_error) == pytest.approx(float(jstate.vof_vol_error), rel=1e-6, abs=1e-15)


def test_state_numpy_round_trip():
    case = get_case("stationary_drop", n=16)
    state = case.make_state(torch.float64, "cpu")
    back = twophase.two_phase_state_from_numpy(twophase.two_phase_state_to_numpy(state), "cpu")
    assert torch.equal(back.vf, state.vf) and torch.equal(back.flow.rho_u, state.flow.rho_u)


def test_fixed_runner_matches_run():
    """The fixed-step runner: steps past t_end have dt = 0 and skip the
    flow; the VOF stage still runs (as in the JAX package) and moves vf
    only by rounding."""
    case = get_case("stationary_drop", n=16)
    t_end = 0.25
    ran = twophase.run(case.make_state(torch.float64, "cpu"), t_end, case.grid, case.cfg)
    runner = twophase.make_fixed_runner(case.grid, case.cfg, 4, torch.float64, "cpu")
    fixed = runner(case.make_state(torch.float64, "cpu"), t_end)
    assert float(fixed.flow.t) == float(ran.flow.t) == pytest.approx(t_end)
    assert float(fixed.flow.dt) == 0.0
    for k in ("U", "V", "p"):
        assert torch.equal(getattr(fixed.flow, k), getattr(ran.flow, k))
    assert float((fixed.vf - ran.vf).abs().max()) <= 1e-14


@pytest.mark.parametrize("change", [
    dict(pressure_precond_refresh="never"),
    dict(pressure_precond_dtype="bf8"),
])
def test_unsupported_options_raise(change):
    case = get_case("stationary_drop", n=16)
    with pytest.raises(ValueError):
        twophase.make_step(case.grid, dataclasses.replace(case.cfg, **change), torch.float64, "cpu")


@pytest.mark.parametrize("refresh", ["solve", "step"])
def test_bf16_preconditioner_runs(refresh):
    """``pressure_precond_dtype="bfloat16"`` runs under both refresh
    policies: the solves reach the tolerance in f64 with a bf16 V-cycle."""
    case = get_case("stationary_drop", n=16)
    cfg = dataclasses.replace(case.cfg, pressure_precond_dtype="bfloat16",
                              pressure_precond_refresh=refresh)
    step = twophase.make_step(case.grid, cfg, torch.float64, "cpu")
    state = step(case.make_state(torch.float64, "cpu"), case.t_end)
    assert float(state.flow.p_res) < cfg.pressure_tol and int(state.flow.p_iter) > 0
    assert bool(torch.isfinite(state.flow.p).all())


def test_unsupported_entry_points_raise():
    """The mesh step runs (tests/test_torch_parallel.py); a mesh whose
    first device is not the state's device is refused."""
    case = get_case("stationary_drop", n=16)
    with pytest.raises(ValueError, match="first device"):
        twophase.make_step(case.grid, case.cfg, torch.float64, "cpu", mesh=SlabMesh(["meta"] * 2))


@pytest.mark.parametrize("name,kwargs", [
    ("stationary_drop", dict(n=16)),
    ("rising_bubble", dict(nx=8)),
    ("wave", dict(ny=8)),
    ("capillary_wave", dict(ny=8)),
    ("channel_with_drop", dict(ny=8)),
    ("wall_bubble", dict(ny=8)),
    ("slow_channel", dict(level=4)),
])
def test_two_phase_cases_initial_state(name, kwargs):
    """Every ported two-phase case builds the JAX package's initial state,
    and its step runs."""
    jstate = jget_case(name, **kwargs).make_state(np.float64)
    case = get_case(name, **kwargs)
    state = case.make_state(torch.float64, "cpu")
    for k in ("U", "V", "rho_u", "rho_v", "visc"):
        assert max_rel(getattr(state.flow, k), getattr(jstate.flow, k)) <= 1e-14, k
    assert max_rel(state.vf, jstate.vf) == 0.0
    state = case.make_step(torch.float64, "cpu")(state, case.t_end)
    assert all(bool(torch.isfinite(t).all()) for t in (state.flow.U, state.flow.V, state.flow.p))
