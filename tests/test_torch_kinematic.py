"""The port's kinematic VOF step (``twophase.make_kinematic_step``, the
``vof_tgv`` case) against the JAX package's, on the CPU in f64.

``vof_tgv`` is held to 1e-8 relative on vf (ELVIRA near-ties: the winning
candidate may flip between two whose errors tie to rounding, ROADMAP §3
fault 3) and to rounding on the prescribed velocity and the time. The JAX
step runs op by op (``__wrapped__``, its function without ``jax.jit``):
the circles are mirror-symmetric, so candidates tie in exact arithmetic,
and the fused program picks the other one of a tie at cells of every
circle at step 1 (vf moves by 4e-3), where the port takes the op-by-op
choice, as for fault 3. The
reference's Taylor-Green invariants (tests/test_vof_tgv.py,
test/TaylorGreenVortexVOF.cpp) are held on the port alone, at scale 1 and
1e-4: per-step volume error below 1e-12 max(scale^2, 1), vf within 1e-8 of
[0, 1], mass conserved to 1e-10 max(scale^2, 1).
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.solvers import twophase
from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator

torch.set_num_threads(1)
VISC, RHO = 0.1, 0.9


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def test_vof_tgv_against_jax():
    """vof_tgv(n=32), 5 steps; each port step makes no host read."""
    jcase, case = jget_case("vof_tgv", n=32), get_case("vof_tgv", n=32)
    jstate, jstep = jcase.make_state(np.float64), jcase.make_step().__wrapped__
    state, step = case.make_state(torch.float64, "cpu"), case.make_step(torch.float64, "cpu")
    for _ in range(5):
        jstate = jstep(jstate, jcase.t_end)
        s0 = sync.count
        state = step(state, case.t_end)
        assert sync.count == s0
        assert float(state.flow.t) == pytest.approx(float(jstate.flow.t), rel=1e-14)
        assert float(state.flow.dt) == pytest.approx(float(jstate.flow.dt), rel=1e-14)
        for k in ("U", "V", "U_old", "V_old"):
            assert max_rel(getattr(state.flow, k), getattr(jstate.flow, k)) <= 1e-14, k
        assert max_rel(state.vf, jstate.vf) <= 1e-8
        assert max_rel(state.interface_length, jstate.interface_length) <= 1e-8
        assert 0.0 <= float(state.vof_vol_error) < 1e-12 and float(jstate.vof_vol_error) < 1e-12
    assert torch.equal(state.flow.p, torch.zeros_like(state.flow.p)) and int(state.flow.p_iter) == 0


@pytest.mark.parametrize("scale", [1.0, 1e-4])
def test_taylor_green_invariants(scale):
    """One circle in the decaying Taylor-Green field on a 64^2 periodic box
    of side 2 pi scale (the tests/test_vof_tgv.py setup), to t = 0.3; the
    viscosity is scaled by scale^2, so each step's dt is that of scale 1."""
    n, t_end = 64, 0.3
    g = make_grid(0.0, 2 * math.pi * scale, n, 0.0, 2 * math.pi * scale, n)
    cfg = dataclasses.replace(get_case("vof_tgv", n=n).cfg, visc_gas=VISC * scale**2,
                              visc_liquid=VISC * scale**2)

    def coord(a):
        return torch.as_tensor(a)

    sin_cos = scale * torch.outer(coord(np.sin(g.x / scale)), coord(np.cos(g.ym / scale)))
    cos_sin = -scale * torch.outer(coord(np.cos(g.xm / scale)), coord(np.sin(g.y / scale)))

    def velocity(t):
        F = torch.exp(-2.0 * VISC / RHO * t)
        return sin_cos * F, cos_sin * F

    vf0 = liquid_fraction_from_indicator(
        lambda x, y: (x / scale - np.pi) ** 2 + (y / scale - 1.5 * np.pi) ** 2 <= 0.25, g)
    state = twophase.init_two_phase_state(g, cfg, vf0, torch.float64, "cpu")
    step = twophase.make_kinematic_step(g, cfg, velocity, torch.float64, "cpu")
    init_int = float(torch.sum(state.vf)) * g.dx * g.dy
    n_steps = 0
    while float(state.flow.t) < t_end - 1e-14:
        state = step(state, t_end)
        n_steps += 1
        assert float(state.vof_vol_error) < 1e-12 * max(scale * scale, 1.0), float(state.vof_vol_error)
        assert abs(float(state.vf.min())) <= 1e-8
        assert abs(float(state.vf.max()) - 1.0) <= 1e-8
        integral = float(torch.sum(state.vf)) * g.dx * g.dy
        assert abs(integral - init_int) <= 1e-10 * max(scale * scale, 1.0), integral - init_int
    assert n_steps >= 30 and float(state.flow.t) == pytest.approx(t_end)
