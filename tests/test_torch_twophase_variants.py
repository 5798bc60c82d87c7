"""The port's two-phase step under the options of the reference's other
branches, against the JAX package, in f64 on the CPU: the tangent-force
surface tension, phase change (``phase_change_mdot``), the dense
advection (``vof_max_active=0``) and ``vof_no_correction`` (kernel #12 on
quads). The regression and convolved curvature and the staggered
backtrace are in ``test_torch_twophase_variants_vof.py``, the expanding
bubble in ``test_torch_sources.py``.

two_phase_channel(ny=16), 3 steps, step by step against the JAX step with
the pressure tolerance tightened to 1e-11 (1e-9 on the intermediate
subiterations), as ``test_torch_twophase.py`` does. Both packages solve
with the same BoxMG hierarchy (the dense coarsest inverse in f64), so
iter(p) is equal and the fields agree to rounding: held at 1e-12 relative
(measured 3.4e-13 at most, the curvature; 6.5e-14 on U, V, p).
"""

import dataclasses

import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync

torch.set_num_threads(1)
TOL = 1e-12


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def run_against_jax(name, kwargs, change, steps=3, eager=False, tols=None):
    """``steps`` steps of case ``name`` with ``change`` in both packages;
    every step holds t, U, V, p, vf, curv and interface_length to TOL
    relative (or to ``tols[field]``), p_iter equal and the host syncs to
    1 + p_iter + solves. Returns the port's last state."""
    tols = {k: TOL for k in ("U", "V", "p", "vf", "curv", "interface_length")} | (tols or {})
    kw = dict(pressure_tol=1e-11, pressure_tol_intermediate=1e-9, **change)
    jcase, tcase = jget_case(name, **kwargs), get_case(name, **kwargs)
    jcase.cfg = dataclasses.replace(jcase.cfg, **kw)
    tcase.cfg = dataclasses.replace(tcase.cfg, **kw)
    jstate, jstep = jcase.make_state(np.float64), jcase.make_step()
    if eager:
        jstep = jstep.__wrapped__
    state, step = tcase.make_state(torch.float64, "cpu"), tcase.make_step(torch.float64, "cpu")
    for _ in range(steps):
        jstate = jstep(jstate, jcase.t_end)
        s0 = sync.count
        state = step(state, tcase.t_end)
        assert sync.count - s0 == 1 + int(state.flow.p_iter) + tcase.cfg.num_subiter
        assert int(state.flow.p_iter) == int(jstate.flow.p_iter)
        assert float(state.flow.t) == pytest.approx(float(jstate.flow.t), rel=1e-14)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state.flow, k), getattr(jstate.flow, k)) <= tols[k], k
        for k in ("vf", "curv", "interface_length"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= tols[k], k
        assert float(state.vof_vol_error) == pytest.approx(float(jstate.vof_vol_error), rel=1e-6, abs=1e-15)
    return state


@pytest.mark.parametrize("change", [
    dict(surface_tension_method="tangent_force"),
    dict(phase_change_mdot=0.01),
    dict(vof_max_active=0),
    dict(vof_no_correction=True),
], ids=["tangent_force", "phase_change", "dense", "no_correction"])
def test_two_phase_channel_options_against_jax(change):
    state = run_against_jax("two_phase_channel", dict(ny=16), change)
    if "surface_tension_method" in change:
        # the tangential pull enters the RHS only: the jump stays zero
        assert float(state.flow.p_jump_u.abs().max()) == 0.0
    assert float(state.vf.min()) >= -1e-12 and float(state.vf.max()) <= 1.0 + 1e-12
