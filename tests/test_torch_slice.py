"""The port's single-phase step (momentum -> BCs -> divergence ->
BoxMG-PCG -> projection) against the JAX package, in f64 on the CPU, where
every kernel module runs its plain PyTorch twin.

In f64 the port's BoxMG hierarchy is the JAX package's CPU one: fused_rap
levels down to a coarsest level solved with the dense inverse. The cases
below run with tight tolerances (1e-10 .. 1e-12); U, V, p are held to
1e-12 relative (measured 1.1e-14 at most) and the PCG iteration counts are
equal.
"""

import dataclasses
import inspect

import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.poisson import boxmg
from fluidsolver_tpu_torch.solvers import incomp
from fluidsolver_tpu_torch.solvers.config import config_from_jax
from fluidsolver_tpu_torch.solvers.state import state_from_numpy, state_to_numpy
from tests.golden_cases import lid_driven_cavity

torch.set_num_threads(1)
TOL = 1e-12


def max_rel(got, want):
    want = np.asarray(want)
    return float(np.abs(np.asarray(got) - want).max() / (np.abs(want).max() or 1.0))


def test_golden_lid_driven_cavity():
    """incomp.run on the golden cavity (64^2, 25 steps, pinned pressure,
    tol 1e-10) against the committed f64 trajectory and the JAX run."""
    jrun = lid_driven_cavity(np.float64)
    # the JAX case's own initial state, config and grid
    case = inspect.getclosurevars(jrun).nonlocals
    jg = case["g"]
    grid = make_grid(jg.x_min, jg.x_max, jg.nx, jg.y_min, jg.y_max, jg.ny)
    state = state_from_numpy(case["state"], "cpu")
    out = state_to_numpy(incomp.run(state, case["t_end"], grid, config_from_jax(case["cfg"])))
    gold = dict(np.load("tests/goldens/lid_driven_cavity.npz"))
    jout = {k: np.asarray(v) for k, v in jrun().items()}
    assert float(out["t"]) == pytest.approx(float(gold["t"]), abs=1e-14)
    for k in ("U", "V", "p"):
        assert max_rel(out[k], gold[k]) <= TOL, (k, max_rel(out[k], gold[k]))
        assert max_rel(out[k], jout[k]) <= TOL, (k, max_rel(out[k], jout[k]))


def _run_both(name, n_steps, pressure_tol, **kwargs):
    jcase, tcase = jget_case(name, **kwargs), get_case(name, **kwargs)
    jcase.cfg = dataclasses.replace(jcase.cfg, pressure_tol=pressure_tol)
    tcase.cfg = dataclasses.replace(tcase.cfg, pressure_tol=pressure_tol)
    jstate, jstep = jcase.make_state(np.float64), jcase.make_step()
    state, step = tcase.make_state(torch.float64, "cpu"), tcase.make_step(torch.float64, "cpu")
    for _ in range(n_steps):
        jstate = jstep(jstate, jcase.t_end)
        state = step(state, tcase.t_end)
        assert float(state.t) == pytest.approx(float(jstate.t), rel=1e-14)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= TOL, (k, max_rel(getattr(state, k), getattr(jstate, k)))
        assert int(state.p_iter) == int(jstate.p_iter)
    return state, step


def test_lid_driven_above_tail_path():
    """lid_driven(200): in f64 every level runs fused_rap + fused_smooth
    down to the dense inverse of the 13^2 level; an f32 build of the same
    operator runs the 202^2 level above a 4-level tail."""
    _, step = _run_both("lid_driven", 3, 1e-12, n=200)
    assert [tuple(lv.op.aC.shape) for lv in step.levels] == [(202, 202), (101, 101), (51, 51), (26, 26), (13, 13)]
    assert all(lv.tail is None for lv in step.levels) and step.levels[-1].coarse_inv is not None
    f32 = boxmg.build_hierarchy(boxmg.cast_struct(step.levels[0].op, torch.float32))
    assert [lv.tail is not None for lv in f32] == [False, True] and len(f32[1].tail.shapes) == 4


@pytest.mark.parametrize("name,kwargs", [
    ("incomp_channel", dict(ny=12)),   # callable inflow, clipped outflow, outflow correction
    ("taylor_green", dict(n=24)),      # periodic, singular pressure system
])
def test_single_phase_cases(name, kwargs):
    _run_both(name, 3, 1e-12, **kwargs)


def test_fixed_runner_matches_run():
    """The fixed-step runner: steps past t_end are dt = 0 no-ops."""
    case = get_case("lid_driven", n=16)
    t_end = 0.03
    ran = incomp.run(case.make_state(torch.float64, "cpu"), t_end, case.grid, case.cfg)
    runner = incomp.make_fixed_runner(case.grid, case.cfg, 6, torch.float64, "cpu")
    fixed = runner(case.make_state(torch.float64, "cpu"), t_end)
    assert float(fixed.t) == float(ran.t) == pytest.approx(t_end)
    assert float(fixed.dt) == 0.0
    for k in ("U", "V", "p"):
        assert torch.equal(getattr(fixed, k), getattr(ran, k))


def test_unsupported_config_raises():
    """A preconditioner dtype that is not a float raises; bf16 runs (its
    hierarchy is built in bf16 at make_step); a state of another dtype
    than the step's raises."""
    case = get_case("lid_driven", n=16)
    with pytest.raises(ValueError):
        incomp.make_step(case.grid, dataclasses.replace(case.cfg, pressure_precond_dtype="bf8"),
                         torch.float64, "cpu")
    cfg16 = dataclasses.replace(case.cfg, pressure_precond_dtype="bfloat16")
    step16 = incomp.make_step(case.grid, cfg16, torch.float64, "cpu")
    assert step16.levels[0].op.aC.dtype == torch.bfloat16
    out = step16(case.make_state(torch.float64, "cpu"), case.t_end)
    assert bool(torch.isfinite(out.p).all()) and float(out.p_res) < case.cfg.pressure_tol
    step = case.make_step(torch.float64, "cpu")
    with pytest.raises(ValueError):
        step(case.make_state(torch.float32, "cpu"), case.t_end)
