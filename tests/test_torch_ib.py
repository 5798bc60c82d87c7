"""The port's immersed boundaries against the JAX package, in f64 on the
CPU: the geometry, the native set-up code (built from the port's own copy
of ``ib_kernels.cpp``) against the JAX package's native and Python
builders, the diffuse, sharp and Luchini fields and their velocity
updates, and the three IB channels (four modes) for 3 steps.

The channels run at a pressure tolerance of 1e-11 and are held to 1e-12
relative on U, V and p with equal PCG iterations, as
``test_torch_twophase.py`` holds its steps (both packages solve with the
same BoxMG hierarchy). The sharp channel uses the bounded quadratic
weights, as ``tests/test_ib.py`` does: the linear ones diverge where the
wall comes near the fluid neighbour (beta -> 1) on coarse grids.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu import native as jnative
from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.ib import diffuse as jdiffuse
from fluidsolver_tpu.ib import geometry as jgeometry
from fluidsolver_tpu.ib import luchini as jluchini
from fluidsolver_tpu.ib import sharp as jsharp
from fluidsolver_tpu.ops import stencil as jstencil
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ib import _native, diffuse, geometry, luchini, sharp
from fluidsolver_tpu_torch.ops import stencil
from tests.test_torch_twophase_variants import max_rel

torch.set_num_threads(1)
WALL = (1.0, 0.5, 0.15)


def T(a):
    return torch.as_tensor(np.array(a))


def test_geometry_matches_jax():
    rng = np.random.default_rng(1)
    px, py = rng.uniform(-1.5, 1.5, 200), rng.uniform(-1.5, 1.5, 200)
    for args, cls, jcls in (((0.1, -0.2, 0.9), geometry.Circle, jgeometry.Circle),
                            ((-0.5, -0.3, 1.1, 0.7), geometry.Rect, jgeometry.Rect)):
        s, js = cls(*args), jcls(*args)
        assert np.array_equal(s.contains(px, py), js.contains(px, py))
    c, jc = geometry.Circle(0.0, 0.0, 1.0), jgeometry.Circle(0.0, 0.0, 1.0)
    assert c.intersect_line((0.5, 0.0), (1.5, 0.0)) == jc.intersect_line((0.5, 0.0), (1.5, 0.0))
    assert c.intersect_line((0.1, 0.2), (-0.9, -0.8)) == jc.intersect_line((0.1, 0.2), (-0.9, -0.8))
    assert c.normal(2.0, 0.0) == jc.normal(2.0, 0.0)
    r, jr = geometry.Rect(0.0, 0.0, 2.0, 1.0), jgeometry.Rect(0.0, 0.0, 2.0, 1.0)
    assert r.intersect_line((1.0, 0.5), (1.0, 1.5)) == jr.intersect_line((1.0, 0.5), (1.0, 1.5))
    with pytest.raises(ValueError):
        c.intersect_line((0.1, 0.1), (0.2, 0.2))


@pytest.fixture(scope="module")
def box():
    """tests/test_native.py's 96 x 32 box with the channels' circle."""
    return make_grid(0.0, 3.0, 96, 0.0, 1.0, 32), jmake_grid(0.0, 3.0, 96, 0.0, 1.0, 32), geometry.Circle(*WALL)


def test_native_luchini_matches_jax_builders(box):
    g, jg, wall = box
    jwall = jgeometry.Circle(*WALL)
    for xs, ys in ((g.x, g.ym), (g.xm, g.y)):
        got = _native.luchini_correction_circle(xs, ys, g.dx, g.dy, *WALL)
        np.testing.assert_allclose(got, jluchini._correction_field(jwall, xs, ys, g.dx, g.dy), rtol=1e-12, atol=1e-9)
        np.testing.assert_allclose(got, luchini._correction_field(wall, xs, ys, g.dx, g.dy), rtol=1e-12, atol=1e-9)
        if jnative.available():
            np.testing.assert_allclose(got, jnative.luchini_correction_circle(xs, ys, g.dx, g.dy, *WALL),
                                       rtol=1e-14, atol=0.0)
        assert np.isinf(got).sum() > 10 and np.isfinite(got).sum() > 1000


@pytest.mark.parametrize("scheme", ["linear", "quadratic"])
def test_native_sharp_matches_jax_builders(box, scheme):
    """The native stencil against the port's and the JAX package's Python
    loops (the same nodes; weights to 1e-10, as tests/test_native.py) and
    the JAX package's native sweep (weights to 1e-14)."""
    g, jg, wall = box
    jwall = jgeometry.Circle(*WALL)
    for xs, ys in ((g.x, g.ym), (g.xm, g.y)):
        nat = _native.sharp_stencil_circle(xs, ys, g.dx, g.dy, *WALL, scheme)
        refs = [sharp._build_stencil(wall, xs, ys, g.dx, g.dy, scheme)]
        js = jsharp._build_stencil(jwall, xs, ys, g.dx, g.dy, scheme)
        refs.append(tuple(np.asarray(getattr(js, k)) for k in ("tgt", "nb1", "nb2", "w1", "w2", "deep")))
        if jnative.available():
            refs.append(jnative.sharp_stencil_circle(xs, ys, g.dx, g.dy, *WALL, scheme))
        o = np.argsort(nat[0])
        for k, ref in enumerate(refs):
            r = np.argsort(ref[0])
            for a, b in ((nat[0], ref[0]), (nat[1], ref[1]), (nat[2], ref[2])):
                np.testing.assert_array_equal(a[o], np.asarray(b)[r])
            tol = 1e-14 if k == 2 else 1e-10
            np.testing.assert_allclose(nat[3][o], np.asarray(ref[3])[r], rtol=tol, atol=1e-15)
            np.testing.assert_allclose(nat[4][o], np.asarray(ref[4])[r], rtol=tol, atol=1e-15)
            np.testing.assert_array_equal(np.sort(nat[5]), np.sort(np.asarray(ref[5])))
        assert len(nat[0]) > 20 and len(nat[5]) > 20


def channel_grids(ny=16):
    return (make_grid(0.0, 5.0, 5 * ny, 0.0, 1.0, ny), jmake_grid(0.0, 5.0, 5 * ny, 0.0, 1.0, ny))


def test_ib_fields_match_jax():
    """The diffuse fractions, the sharp stencils of both schemes (the
    channel's circle and a FunctionShape ellipse, which takes the Python
    loop) and the Luchini fields on the ny=16 channel, against the JAX
    package's."""
    g, jg = channel_grids()
    wall, jwall = geometry.Circle(*WALL), jgeometry.Circle(*WALL)
    d, jd = diffuse.solid_fractions(wall.contains, g, torch.float64, "cpu"), jdiffuse.solid_fractions(jwall.contains, jg)
    for k in ("ib", "ib_u", "ib_v"):
        assert max_rel(getattr(d, k), getattr(jd, k)) <= 1e-15, k
    lu, jlu = luchini.correction_fields(wall, g, torch.float64, "cpu"), jluchini.correction_fields(jwall, jg)
    for k in ("corr_u", "corr_v"):
        a, b = getattr(lu, k).numpy(), np.asarray(getattr(jlu, k))
        assert np.array_equal(np.isinf(a), np.isinf(b))
        np.testing.assert_allclose(a[np.isfinite(a)], b[np.isfinite(b)], rtol=1e-12, atol=1e-9)

    def ellipse(x, y):
        return 1.0 - ((x - 1.0) / 0.2) ** 2 - ((y - 0.5) / 0.12) ** 2

    def normal(x, y):
        n = np.array([(x - 1.0) / 0.04, (y - 0.5) / 0.0144])
        return tuple(n / np.hypot(*n))

    shapes = [(wall, jwall), (sharp.FunctionShape(ellipse, normal), jsharp.FunctionShape(ellipse, normal))]
    for (s, js) in shapes:
        for scheme in ("linear", "quadratic"):
            got, want = sharp.build(s, g, torch.float64, "cpu", scheme=scheme), jsharp.build(js, jg, scheme=scheme)
            for axis in ("u", "v"):
                a, b = getattr(got, axis), getattr(want, axis)
                o, r = np.argsort(a.tgt.numpy()), np.argsort(np.asarray(b.tgt))
                for k in ("tgt", "nb1", "nb2"):
                    np.testing.assert_array_equal(getattr(a, k).numpy()[o], np.asarray(getattr(b, k))[r])
                    assert getattr(a, k).dtype == torch.int64
                for k in ("w1", "w2"):
                    np.testing.assert_allclose(getattr(a, k).numpy()[o], np.asarray(getattr(b, k))[r],
                                               rtol=1e-10, atol=1e-15)
                np.testing.assert_array_equal(np.sort(a.deep.numpy()), np.sort(np.asarray(b.deep)))


def test_ib_velocity_updates_match_jax():
    """apply_direct_forcing, sharp.apply_forcing and both Luchini updates on
    random fields of the ny=16 channel, against the JAX package to 1e-15."""
    g, jg = channel_grids()
    wall, jwall = geometry.Circle(*WALL), jgeometry.Circle(*WALL)
    rng = np.random.default_rng(2)
    U, V, U_old, V_old, dU, dV = (rng.normal(size=s) for s in (g.shape_u, g.shape_v) * 3)
    rho_u, rho_v, rho_u_old, rho_v_old = (rng.uniform(0.5, 2.0, size=s) for s in (g.shape_u, g.shape_v) * 2)
    visc = rng.uniform(1e-3, 2e-3, size=g.shape_center)
    dt = 7e-3

    def close(got, want):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=1e-15)

    d = diffuse.solid_fractions(wall.contains, g, torch.float64, "cpu")
    close(diffuse.apply_direct_forcing(T(U), T(V), d, 0.3, -0.1),
          jdiffuse.apply_direct_forcing(jnp.asarray(U), jnp.asarray(V), jdiffuse.solid_fractions(jwall.contains, jg),
                                        0.3, -0.1))
    st = sharp.build(wall, g, torch.float64, "cpu", scheme="quadratic")
    close(sharp.apply_forcing(T(U), T(V), st),
          jsharp.apply_forcing(jnp.asarray(U), jnp.asarray(V), jsharp.build(jwall, jg, scheme="quadratic")))
    lu, jlu = luchini.correction_fields(wall, g, torch.float64, "cpu"), jluchini.correction_fields(jwall, jg)
    args = (U_old, V_old, rho_u_old, rho_v_old, rho_u, rho_v, visc, U, V)
    close(luchini.update_velocity_semi_analytical(T(dU), T(dV), dt, lu, *map(T, args)),
          jluchini.update_velocity_semi_analytical(jnp.asarray(dU), jnp.asarray(dV), dt, jlu, *map(jnp.asarray, args)))
    close(luchini.correct_velocity_implicit_euler(T(U), T(V), lu, dt, T(visc), T(rho_u), T(rho_v)),
          jluchini.correct_velocity_implicit_euler(jnp.asarray(U), jnp.asarray(V), jlu, dt, jnp.asarray(visc),
                                                   jnp.asarray(rho_u), jnp.asarray(rho_v)))


@pytest.mark.parametrize("name,kwargs", [
    ("diffuse_ib_channel", {}),
    ("sharp_ib_channel", dict(scheme="quadratic")),
    ("luchini_ib_channel", {}),
    ("luchini_ib_channel", dict(implicit=True)),
], ids=["diffuse", "sharp", "luchini", "luchini_implicit"])
def test_ib_channel_against_jax(name, kwargs):
    """ny=16, 3 steps at a pressure tolerance of 1e-11: t, U, V, p to 1e-12
    relative (measured 2.5e-14 at most), the same PCG iterations and the
    host syncs of a step 1 + p_iter + solves."""
    jcase, tcase = jget_case(name, ny=16, **kwargs), get_case(name, ny=16, **kwargs)
    jcase.cfg = dataclasses.replace(jcase.cfg, pressure_tol=1e-11)
    tcase.cfg = dataclasses.replace(tcase.cfg, pressure_tol=1e-11)
    jstate, jstep = jcase.make_state(np.float64), jcase.make_step()
    state, step = tcase.make_state(torch.float64, "cpu"), tcase.make_step(torch.float64, "cpu")
    for _ in range(3):
        jstate = jstep(jstate, jcase.t_end)
        s0 = sync.count
        state = step(state, tcase.t_end)
        assert sync.count - s0 == 1 + int(state.p_iter) + tcase.cfg.num_subiter
        assert int(state.p_iter) == int(jstate.p_iter)
        assert float(state.t) == pytest.approx(float(jstate.t), rel=1e-14)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= 1e-12, k
    div = stencil.divergence(state.U, state.V, tcase.grid.dx, tcase.grid.dy)[1:-1, 1:-1]
    jdiv = jstencil.divergence(jstate.U, jstate.V, jcase.grid.dx, jcase.grid.dy)[1:-1, 1:-1]
    assert float(div.abs().max()) <= 1e-6 and float(jnp.abs(jdiv).max()) <= 1e-6


@pytest.mark.parametrize("name,kwargs", [
    ("diffuse_ib_channel", {}), ("sharp_ib_channel", dict(scheme="quadratic")), ("luchini_ib_channel", {})])
def test_ib_channel_invariants(name, kwargs):
    """tests/test_ib.py's physics check on the port (ny=32, 12 steps): no
    NaN, |U| deep in the solid below 0.15, max |div| below 1e-3, and the
    flow faster than 1.5 through the gap over the cylinder."""
    case = get_case(name, ny=32, **kwargs)
    g, wall = case.grid, case.meta["wall"]
    state, step = case.make_state(torch.float64, "cpu"), case.make_step(torch.float64, "cpu")
    for _ in range(12):
        state = step(state, 1e9)
    U = state.U.numpy()
    assert not np.isnan(U).any()
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    deep = (Xu - wall.x) ** 2 + (Yu - wall.y) ** 2 < (0.5 * wall.r) ** 2
    assert deep.any() and np.abs(U[deep]).max() < 0.15
    div = stencil.divergence(state.U, state.V, g.dx, g.dy)[1:-1, 1:-1]
    assert float(div.abs().max()) < 1e-3
    assert np.abs(U[int(wall.x / g.dx) + 1, :]).max() > 1.5


def test_ib_mode_needs_fields():
    case = get_case("diffuse_ib_channel", ny=8)
    from fluidsolver_tpu_torch.solvers import incomp

    with pytest.raises(ValueError):
        incomp.make_step(case.grid, case.cfg, torch.float64, "cpu")
    with pytest.raises(ValueError):
        incomp.make_step(case.grid, dataclasses.replace(case.cfg, ib_mode="penalty"), torch.float64, "cpu",
                         ib=object())
