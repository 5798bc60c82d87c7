"""The port's moving-least-squares stencils (``ib/mls.py``), Lagrangian
markers (``ib/markers.py``) and the immersed-interface case against the
JAX package on the CPU in f64: ``tests/test_ib.py``'s MLS protocols and
``tests/test_curvature_methods.py``'s immersed-interface run (n=24, 40
markers, 5 steps). The functions are held to the JAX package's to 1e-12
of the largest value; the case to the tolerance of its pressure solves
(measured gaps in the test)."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.ib import markers as jmk
from fluidsolver_tpu.ib import mls as jmls
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ib import markers as mk
from fluidsolver_tpu_torch.ib import mls
from fluidsolver_tpu_torch.ops.stencil import sample_centered

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, tol=1e-12):
    want = np.asarray(want)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.abs(got - want).max() <= tol * (np.abs(want).max() or 1.0), np.abs(got - want).max()


# ---- MLS ------------------------------------------------------------------------
def test_mls_linear_reproduction_and_shape_functions():
    """A linear basis reproduces linear fields exactly; the shape functions
    of a batch of points equal the JAX package's."""
    rng = np.random.default_rng(0)
    px, py = rng.uniform(0, 1, 5), rng.uniform(0, 1, 5)
    vals = 2.0 * px - 3.0 * py + 0.5
    got = mls.mls_interpolate(T(px), T(py), T(vals), T(0.4), T(0.6), h=1.0)
    assert abs(float(got) - (2.0 * 0.4 - 3.0 * 0.6 + 0.5)) < 1e-10
    bx, by = rng.uniform(0, 1, (7, 6)), rng.uniform(0, 1, (7, 6))
    ex, ey = rng.uniform(0.2, 0.8, 7), rng.uniform(0.2, 0.8, 7)
    close(mls.mls_shape_functions(T(bx), T(by), T(ex), T(ey), 0.6),
          jmls.mls_shape_functions(jnp.asarray(bx), jnp.asarray(by), jnp.asarray(ex),
                                   jnp.asarray(ey), 0.6))
    r = np.linspace(-2.5, 2.5, 41)
    close(mls.cubic_spline_weight(T(r), 1.0), jmls.cubic_spline_weight(jnp.asarray(r), 1.0))


def test_mls_point_eval_vs_bilinear_and_nn():
    """The MovingLeastSquaresIB experiment on a 32^2 staggered TGV field:
    the 5-point MLS sample is as accurate as the bilinear one and beats the
    nearest neighbour; both samplers equal the JAX package's at a batch of
    points."""
    g = make_grid(0.0, 2 * math.pi, 32, 0.0, 2 * math.pi, 32)
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    U = np.sin(Xu) * np.cos(Yu)
    ua = math.sin(3.0) * math.cos(4.0)
    px, py = T(3.0), T(4.0)
    e_bil = abs(float(sample_centered(T(U), g.x[1], g.dx, g.ym[1], g.dy, px, py)) - ua)
    e_nn = abs(float(mls.eval_field_at_nn(T(U), g.x[1], g.dx, g.ym[1], g.dy, px, py)) - ua)
    e_mls = abs(float(mls.eval_field_at_mls5(T(U), g.x[1], g.dx, g.ym[1], g.dy, px, py)) - ua)
    assert e_mls < 2.0 * max(e_bil, 1e-12) and e_mls < 1e-2, (e_mls, e_bil)
    assert e_mls < e_nn

    rng = np.random.default_rng(2)
    qx, qy = rng.uniform(0.3, 6.0, 50), rng.uniform(0.3, 6.0, 50)
    args = (g.x[1], g.dx, g.ym[1], g.dy)
    close(mls.eval_field_at_mls5(T(U), *args, T(qx), T(qy)),
          jmls.eval_field_at_mls5(jnp.asarray(U), *args, jnp.asarray(qx), jnp.asarray(qy)))
    close(mls.eval_field_at_nn(T(U), *args, T(qx), T(qy)),
          jmls.eval_field_at_nn(jnp.asarray(U), *args, jnp.asarray(qx), jnp.asarray(qy)), 0.0)


# ---- markers --------------------------------------------------------------------
def test_markers_match_jax():
    """A perturbed 40-marker ring on a 24^2 grid: sampling, advection,
    response force, normals, jump conditions and the spread force."""
    g = make_grid(0.0, 1.0, 24, 0.0, 1.0, 24)
    jg = jmake_grid(0.0, 1.0, 24, 0.0, 1.0, 24)
    m = mk.init_circle(40, 0.5, 0.4, 0.2, torch.float64, "cpu")
    jm = jmk.init_circle(40, 0.5, 0.4, 0.2, dtype=jnp.float64)
    close(m.x, jm.x, 1e-15)
    close(m.y, jm.y, 1e-15)
    rng = np.random.default_rng(4)
    Ui, Vi = rng.normal(size=g.shape_center), rng.normal(size=g.shape_center)
    m = mk.advect(mk.sample_velocity(m, T(Ui), T(Vi), g), 0.01)
    jm = jmk.advect(jmk.sample_velocity(jm, jnp.asarray(Ui), jnp.asarray(Vi), jg), 0.01)
    for f in ("x", "y", "u", "v"):
        close(getattr(m, f), getattr(jm, f))
    jumps, jjumps = mk.jump_conditions(m, 1.3, 0.7), jmk.jump_conditions(jm, 1.3, 0.7)
    for k in jjumps:
        close(jumps[k], jjumps[k], 1e-11)
    fu, fv = mk.response_force(m, 1.3, 0.7)
    jfu, jfv = jmk.response_force(jm, 1.3, 0.7)
    fU, fV = mk.spread_force(m, fu, fv, g, g.shape_u, g.shape_v)
    jfU, jfV = jmk.spread_force(jm, jfu, jfv, jg, jg.shape_u, jg.shape_v)
    assert tuple(fU.shape) == g.shape_u and tuple(fV.shape) == g.shape_v
    close(fU, jfU)
    close(fV, jfV)


# ---- the immersed-interface case -------------------------------------------------
def test_immersed_interface_case_matches_jax():
    """5 steps of immersed_interface(n=24, n_markers=40) against the JAX
    case, step by step. The case solves to tol 1e-6, where the port's
    BoxMG sweeps its coarsest level and the JAX package's CPU path inverts
    it (ROADMAP fault 1), so the fields agree to the solve tolerance:
    measured U, V, p within 5.9e-7 of their largest values (held to 1e-5),
    marker positions within 1.8e-11 and velocities within 2.1e-9 (held to
    1e-10 and 1e-8), and 55 against 40 pressure iterations over the 10
    solves (held to 2 a solve). The markers move and their jumps are
    finite."""
    case = get_case("immersed_interface", n=24, n_markers=40)
    jcase = jget_case("immersed_interface", n=24, n_markers=40)
    state, step = case.make_state(torch.float64, "cpu"), case.make_step(torch.float64, "cpu")
    jstate, jstep = jcase.make_state(jnp.float64), jcase.make_step()
    for n in range(1, 6):
        s0, it0 = sync.count, int(state.flow.p_iter)
        state = step(state, 1e9)
        jstate = jstep(jstate, 1e9)
        # one exit test an iteration, one more a solve (p_iter accumulates
        # over the steps, in both packages)
        assert sync.count - s0 == int(state.flow.p_iter) - it0 + case.cfg.num_subiter
        for k in ("U", "V", "p"):
            close(getattr(state.flow, k), getattr(jstate.flow, k), 1e-5)
        for f, tol in (("x", 1e-10), ("y", 1e-10), ("u", 1e-8), ("v", 1e-8)):
            assert np.abs(getattr(state.markers, f).numpy()
                          - np.asarray(getattr(jstate.markers, f))).max() <= tol, f
        assert abs(int(state.flow.p_iter) - int(jstate.flow.p_iter)) <= 2 * n * case.cfg.num_subiter
        assert float(state.flow.t) == pytest.approx(float(jstate.flow.t), rel=1e-14)
    assert not bool(torch.isnan(state.flow.U).any()) and not bool(torch.isnan(state.markers.x).any())
    assert float(torch.max(torch.abs(state.markers.x - state.markers.x0))) > 1e-6
    assert bool(torch.isfinite(mk.jump_conditions(state.markers, 1.0, 1.0)["p_jump"]).all())
