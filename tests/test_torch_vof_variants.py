"""The port's VOF variants against the JAX package, in f64 on the CPU: the
dense all-cells advection, the A/B advection variants (no_correction,
staggered), the quad start polygon of kernel #12's twin, the regression
and convolved curvature estimators and the tangent surface-tension force.

Inputs are made with numpy and handed to both packages. The advection
loops reconstruct with the port's ELVIRA (held to the JAX package's in
``test_torch_vof.py``) and hand the planes to both packages' advection:
the JAX package's jitted ELVIRA flips near-tied candidates against its own
op-by-op run (vf 8.6e-4 apart after a few steps of the 96^2 shear, the
port matching the op-by-op run to 1e-14), and its op-by-op run costs
~2.5 s a step here.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.ops import momentum as jmom
from fluidsolver_tpu.ops import stencil as jstencil
from fluidsolver_tpu.vof import advect as jadv
from fluidsolver_tpu.vof import curvature as jcurv
from fluidsolver_tpu.vof import plic as jplic
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.vof import advect, cuda_advect, curvature, plic
from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator
from tests.geom_util import circle_cell_fractions
from tests.test_surface_tension import _oracle_tangent_force

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def grids(n):
    return make_grid(0.0, 1.0, n, 0.0, 1.0, n), jmake_grid(0.0, 1.0, n, 0.0, 1.0, n)


def disk(g, cx, cy, r):
    return liquid_fraction_from_indicator(lambda x, y: (x - cx) ** 2 + (y - cy) ** 2 <= r**2, g)


def velocity(g, kind):
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    Xv, Yv = np.meshgrid(g.xm, g.y, indexing="ij")
    if kind == "shear":
        return 0.6 + 0.4 * Yu, 0.3 - 0.2 * Xv
    return np.sin(np.pi * Xu) * np.cos(np.pi * Yu), -np.cos(np.pi * Xv) * np.sin(np.pi * Yv)


class Pair:
    """One advection loop in each package on the same velocity."""

    def __init__(self, g, jg, U, V, dt):
        self.g, self.jg, self.dt = g, jg, dt
        self.t = [T(U), T(V)]
        self.t += [stencil.interp_u_center(self.t[0]), stencil.interp_v_center(self.t[1])]
        self.j = [jnp.asarray(U), jnp.asarray(V)]
        self.j += [jstencil.interp_u_center(self.j[0]), jstencil.interp_v_center(self.j[1])]
        self._jitted = {}

    def port(self, vf, **kw):
        rec = plic.elvira(vf, self.g.dx, self.g.dy)
        return advect.advect(vf, rec, *self.t, self.g, torch.tensor(self.dt, dtype=torch.float64), **kw)

    def jax(self, vf, **kw):
        key = tuple(sorted(kw.items()))
        if key not in self._jitted:
            self._jitted[key] = jax.jit(
                lambda v, rec: jadv.advect(v, rec, *self.j, self.jg, self.dt, **kw))
        rec = plic.elvira(T(vf), self.g.dx, self.g.dy)
        jrec = jplic.Plic(*(jnp.asarray(t.numpy()) for t in (rec.nx, rec.ny, rec.d, rec.valid)),
                          overflow=jnp.asarray(False))
        return self._jitted[key](vf, jrec)


def test_dense_advection_matches_jax_dense_and_port_sparse():
    """The dense path (max_active=0) on the 96^2 deforming shear of
    tests/test_vof_advect.py, 6 steps: against the JAX package's dense path
    and against the port's own sparse path, vf to 1e-14 and the volume
    errors to 1e-18, as the JAX package holds its two paths."""
    g, jg = grids(96)
    pair = Pair(g, jg, *velocity(g, "shear"), 0.4 * g.dx)
    vf0 = disk(g, 0.35, 0.4, 0.18)
    vf_d, vf_s, vf_j = T(vf0), T(vf0), jnp.asarray(vf0)
    for _ in range(6):
        vf_d, err_d = pair.port(vf_d, max_active=0)
        vf_s, err_s = pair.port(vf_s)
        vf_j, err_j = pair.jax(vf_j, max_active=0)
        assert float((vf_d - vf_s).abs().max()) <= 1e-14
        assert float(np.abs(vf_d.numpy() - np.asarray(vf_j)).max()) <= 1e-14
        assert abs(float(err_d) - float(err_s)) < 1e-18
        assert abs(float(err_d) - float(err_j)) < 1e-18
    assert int(torch.count_nonzero((vf_d > 0) & (vf_d < 1))) > 100


def tgv_pair():
    g, jg = grids(48)
    return Pair(g, jg, *velocity(g, "tgv"), 5e-3), disk(g, 0.47, 0.52, 0.2)


@pytest.mark.parametrize("variant", ["no_correction", "staggered"])
def test_advection_variants_match_jax(variant):
    """The A/B variants on the 48^2 Taylor-Green field of
    tests/test_vof_advect.py (dt 5e-3, 6 steps): vf step by step against
    the JAX package to 1e-13, and the A/B invariants there: the quad's
    volume error far above the octagon's yet below a cell, the staggered
    trace conservative to 1e-10. The disk sits off the box's centre: a
    centred one ties ELVIRA's candidates exactly (mirror-symmetric cells),
    where either package may take either."""
    pair, vf0 = tgv_pair()
    g = pair.g
    vf, jvf, base = T(vf0), jnp.asarray(vf0), T(vf0)
    worst = err_base = 0.0
    for _ in range(6):
        vf, err = pair.port(vf, **{variant: True})
        jvf, jerr = pair.jax(jvf, **{variant: True})
        base, eb = pair.port(base)
        worst, err_base = max(worst, float(err)), max(err_base, float(eb))
        assert float(np.abs(vf.numpy() - np.asarray(jvf)).max()) <= 1e-13
        assert float(err) == pytest.approx(float(jerr), rel=1e-9, abs=1e-18)
    assert err_base < 1e-12
    if variant == "no_correction":
        assert 1e3 * max(err_base, 1e-300) < worst < g.dx * g.dy
    else:
        assert worst < 1e-10
        assert abs(float(vf.sum()) - float(vf0.sum())) * g.dx * g.dy < 1e-10


@pytest.mark.parametrize("variant", ["no_correction", "staggered"])
def test_dense_variants_match_sparse(variant):
    """Each variant through the dense path equals its sparse path (the
    kernel's quad lanes on the card) to 1e-14 over 2 steps of the 48^2
    Taylor-Green field."""
    pair, vf0 = tgv_pair()
    vf_d = vf_s = T(vf0)
    for _ in range(2):
        vf_d, err_d = pair.port(vf_d, max_active=0, **{variant: True})
        vf_s, err_s = pair.port(vf_s, **{variant: True})
        assert float((vf_d - vf_s).abs().max()) <= 1e-14
        assert abs(float(err_d) - float(err_s)) < 1e-18


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_quad_overlap_twin_matches_jax(mode, monkeypatch):
    """Kernel #12's twin on quad start polygons (the no_correction lanes of
    a swirl on two noisy drops) against advect._overlap_sparse with the
    same four slots: its XLA chain ("off") and once the TPU kernel in
    interpret mode (n0 = 4). Fill lanes gather the all-gas corner and give
    +0."""
    monkeypatch.setattr(jadv, "_PALLAS_OVERRIDE", mode)
    g = make_grid(0.0, 1.0, 37, 0.0, 1.3, 53)
    rng = np.random.default_rng(0)
    vf = liquid_fraction_from_indicator(
        lambda x, y: ((x - 0.45) ** 2 + (y - 0.62) ** 2 <= 0.27**2) | ((x - 0.2) ** 2 + (y - 0.2) ** 2 <= 0.1**2), g)
    vf = np.clip(vf + 0.02 * rng.standard_normal(vf.shape) * ((vf > 0) & (vf < 1)), 0.0, 1.0)
    U, V = velocity(g, "tgv")
    Ut, Vt = T(U), T(V)
    rec = plic.elvira(T(vf), g.dx, g.dy)
    lanes = advect.prepare_lanes(T(vf), Ut, Vt, stencil.interp_u_center(Ut), stencil.interp_v_center(Vt), g,
                                 torch.tensor(0.5 * g.dx, dtype=torch.float64),
                                 advect.default_max_active(g.nx, g.ny), no_correction=True)
    assert lanes.slots_x.shape[0] == 4 and int(lanes.n_active) > 500
    got_ov, got_area = cuda_advect.overlap(lanes.slots_x, lanes.slots_y, T(vf), rec, lanes.iig, lanes.jjg,
                                           g.dx, g.dy)
    gathered = cuda_advect.gather_neighbourhood(T(vf), rec, lanes.iig, lanes.jjg).numpy()
    want_ov, want_area = jadv._overlap_sparse(
        [jnp.asarray(s) for s in lanes.slots_x.numpy()], [jnp.asarray(s) for s in lanes.slots_y.numpy()],
        jnp.asarray(gathered), g.dx, g.dy, jnp.float64)
    np.testing.assert_allclose(got_ov.numpy(), np.asarray(want_ov), rtol=0.0, atol=1e-13)
    np.testing.assert_allclose(got_area.numpy(), np.asarray(want_area), rtol=1e-10, atol=1e-15)
    fill = lanes.is_fill.numpy()
    assert fill.any() and np.all(got_ov.numpy()[fill] == 0.0) and not np.signbit(got_ov.numpy()[fill]).any()
    # the kernel's wrapper takes octagons and quads only
    with pytest.raises(ValueError):
        cuda_advect.overlap_cuda(lanes.slots_x[:3], lanes.slots_y[:3], T(vf), rec, lanes.iig, lanes.jjg,
                                 g.dx, g.dy)


@pytest.fixture(scope="module")
def circle64():
    g, jg = grids(64)
    vf = circle_cell_fractions(jg, 0.5, 0.5, 0.25)
    jrec = jplic.elvira(jnp.asarray(vf), jg.dx, jg.dy)
    rec = plic.Plic(T(jrec.nx), T(jrec.ny), T(jrec.d), T(jrec.valid), overflow=torch.zeros((), dtype=torch.bool))
    return g, jg, vf, jrec, rec


@pytest.mark.parametrize("method,kw,median_bound", [
    ("regression", {}, 0.05), ("convolved", {}, 0.15), ("convolved", {"interpolate": False}, 0.2)])
def test_curvature_methods_match_jax(method, kw, median_bound, circle64):
    """The regression and convolved estimators on the 64^2 circle (r = 0.25)
    of tests/test_curvature_methods.py: against the JAX package to 1e-12 of
    the largest curvature, and the JAX test's bounds on the median error
    against kappa = 4."""
    g, jg, vf, jrec, rec = circle64
    name = {"regression": "curvature_quad_regression", "convolved": "curvature_convolved_vf"}[method]
    got = getattr(curvature, name)(T(vf), rec, g, **kw).numpy()
    want = np.asarray(getattr(jcurv, name)(jnp.asarray(vf), jrec, jg, **kw))
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    valid = np.asarray(jrec.valid)
    assert valid.sum() > 50 and np.all(got[~valid] == 0.0)
    assert np.median(np.abs(got[valid] - 4.0) / 4.0) < median_bound


def test_grad_centered_matches_jax():
    f = np.random.default_rng(4).normal(size=(13, 9))
    got = stencil.grad_centered(T(f), 0.3, 0.7)
    want = jstencil.grad_centered(jnp.asarray(f), 0.3, 0.7)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-15, atol=1e-15)


def test_tangent_force_matches_jax_and_oracle():
    """calc_surface_tension_force on random unit normals and masks (the
    field of tests/test_surface_tension.py): against the JAX package and
    against the reference's loop transcribed there, atol 1e-14."""
    rng = np.random.default_rng(7)
    ncx, ncy = 10, 9
    theta = rng.uniform(0.0, 2.0 * np.pi, (ncx, ncy))
    nxa, nya = np.cos(theta), np.sin(theta)
    valid = rng.uniform(size=(ncx, ncy)) < 0.5
    valid[0, :] = valid[-1, :] = valid[:, 0] = valid[:, -1] = False
    sigma = 0.37
    got = mom.calc_surface_tension_force(T(nxa), T(nya), T(valid), sigma)
    want = jmom.calc_surface_tension_force(jnp.asarray(nxa), jnp.asarray(nya), jnp.asarray(valid), sigma,
                                           jnp.zeros((ncx + 1, ncy)), jnp.zeros((ncx, ncy + 1)))
    oracle = _oracle_tangent_force(nxa, nya, valid, sigma)
    for a, b, o in zip(got, want, oracle):
        assert a.shape == o.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0.0, atol=1e-14)
        np.testing.assert_allclose(a.numpy(), o, rtol=0.0, atol=1e-14)
    assert np.count_nonzero(got[0].numpy()) and np.count_nonzero(got[1].numpy())
