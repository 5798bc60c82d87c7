"""The port's sharded sparse VOF advection (``parallel/dist_vof.py``, the
slab view of ``vof/advect.py`` and the sampler's ``x_clamp``) against the
JAX package's on the JAX tests' eight-device CPU mesh and against the
port's single-device sparse path, in f64. Differences are rounding (the
shifted sampler origin can move a cell-boundary floor by one ulp): held to
1e-12, as tests/test_dist_vof.py holds JAX's sharded path.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fluidsolver_tpu.ops import stencil as jstencil
from fluidsolver_tpu.parallel import dist_vof as jdv
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.parallel import dist_vof
from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
from fluidsolver_tpu_torch.vof import advect as adv
from fluidsolver_tpu_torch.vof import plic
from tests.test_dist_vof import _case

torch.set_num_threads(1)
MESH = SlabMesh(["cpu"] * 8)


def T(a):
    return torch.as_tensor(np.array(a))


def port_case(nx, ny, flow):
    g, vf, rec, U, V, Ui, Vi = _case(nx, ny, flow)
    grid = make_grid(g.x_min, g.x_max, g.nx, g.y_min, g.y_max, g.ny)
    trec = plic.Plic(**{f.name: T(getattr(rec, f.name)) for f in dataclasses.fields(plic.Plic)})
    return (g, (vf, rec, U, V, Ui, Vi)), (grid, [T(vf), trec, T(U), T(V), T(Ui), T(Vi)])


@pytest.mark.parametrize("nx,ny,flow", [(64, 64, "tgv"), (48, 40, "const")])
def test_sharded_matches_jax_and_single_device(nx, ny, flow):
    (g, jargs), (grid, args) = port_case(nx, ny, flow)
    dt, m = 0.4 * g.dx, adv.default_max_active(nx, ny)
    want, want_err = jax.jit(lambda *a: jdv.advect_sharded(
        Mesh(np.array(jax.devices()), ("x",)), *a, grid=g, dt=dt, m_total=m))(*jargs)
    got, err = dist_vof.advect_sharded(MESH, *args, grid, dt, m)
    assert got.shape == args[0].shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(float(err), float(want_err), rtol=1e-8, atol=1e-14)
    single, single_err = adv.advect(*args, grid, dt, max_active=m)
    np.testing.assert_allclose(got.numpy(), single.numpy(), rtol=0.0, atol=1e-12)
    np.testing.assert_allclose(float(err), float(single_err), rtol=1e-8, atol=1e-14)


def test_sharded_conservation():
    """Mass and bounds through five sharded advections, each from the
    port's ELVIRA of the last."""
    _, (grid, (vf, _, U, V, Ui, Vi)) = port_case(64, 64, "const")
    dt, m = 0.4 * grid.dx, adv.default_max_active(64, 64)
    m0 = float(vf.sum()) * grid.dx * grid.dy
    for _ in range(5):
        rec = plic.elvira(vf, grid.dx, grid.dy)
        vf, err = dist_vof.advect_sharded(MESH, vf, rec, U, V, Ui, Vi, grid, dt, m)
        assert float(err) < 1e-12
    assert abs(float(vf.sum()) * grid.dx * grid.dy - m0) < 1e-12
    assert float(vf.min()) >= -1e-12 and float(vf.max()) <= 1 + 1e-12


def test_sharded_overflow_is_loud():
    _, (grid, args) = port_case(64, 64, "const")
    _, err = dist_vof.advect_sharded(MESH, *args, grid, 0.4 * grid.dx, m_total=16)
    assert np.isinf(float(err))


def test_available_and_plan_rows_match_jax():
    for nx, ndev in ((64, 8), (30, 8), (1024, 4), (8, 4)):
        g = make_grid(0.0, 1.0, nx, 0.0, 1.0, 16)
        assert dist_vof.plan_rows(g, nx + 3, ndev) == jdv.plan_rows(g, nx + 3, ndev)
        assert dist_vof.available(g, ndev) == jdv.available(g, ndev)


def test_sampler_x_clamp_matches_jax():
    """``sample_centered_stack(x_clamp=)`` on a halo-extended slab against
    the JAX package's at points inside, at the domain's edges and beyond
    them: the same values (f64, 1e-15)."""
    rng = np.random.default_rng(5)
    fields = rng.normal(size=(2, 20, 14))
    dx, dy, x0, y0 = 0.1, 0.1, 0.05, 0.05
    px = rng.uniform(-0.3, 1.3, size=(40, 4))
    py = rng.uniform(-0.3, 1.3, size=(40, 4))
    for row_off in (-4, -2):
        clamp = (x0, 10, -row_off)
        x_loc = x0 + row_off * dx
        want = jstencil.sample_centered_stack(jnp.asarray(fields), jnp.asarray(x_loc), dx, y0, dy,
                                              jnp.asarray(px), jnp.asarray(py), x_clamp=clamp)
        got = stencil.sample_centered_stack(T(fields), x_loc, dx, y0, dy, T(px), T(py),
                                            x_clamp=clamp)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0, atol=1e-15)
