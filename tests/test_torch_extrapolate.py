"""The port's divergence-free extrapolation (``ops/extrapolate.py``)
against the JAX package's on the CPU in f64: the three protocols of
``tests/test_extrapolate.py`` (TGV velocity known inside a circle,
extrapolated outward) on the port, and the port's fields against the JAX
package's to 1e-10 of their largest value. Each CG iteration makes one
counted host read."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.ops import extrapolate as jext
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ops import extrapolate, stencil

torch.set_num_threads(1)


def setup(n=24):
    g = make_grid(0.0, 1.0, n, 0.0, 1.0, n)
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    Xv, Yv = np.meshgrid(g.xm, g.y, indexing="ij")
    in_u = (Xu - 0.5) ** 2 + (Yu - 0.5) ** 2 <= 0.25 ** 2
    in_v = (Xv - 0.5) ** 2 + (Yv - 0.5) ** 2 <= 0.25 ** 2
    U0 = np.where(in_u, np.sin(2 * np.pi * Xu) * np.cos(2 * np.pi * Yu), 0.0)
    V0 = np.where(in_v, -np.cos(2 * np.pi * Xv) * np.sin(2 * np.pi * Yv), 0.0)
    return g, U0, V0, in_u, in_v


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, tol=1e-10):
    want = np.asarray(want)
    assert np.abs(got.numpy() - want).max() <= tol * (np.abs(want).max() or 1.0)


def outside_mask(g, r):
    Xc, Yc = np.meshgrid(g.xm, g.ym, indexing="ij")
    out = (Xc - 0.5) ** 2 + (Yc - 0.5) ** 2 > r ** 2
    out[0, :] = out[-1, :] = False
    out[:, 0] = out[:, -1] = False
    return torch.as_tensor(out)


def test_constant_field_extrapolates_exactly():
    g, _, _, in_u, _ = setup()
    f = np.where(in_u, 3.5, 0.0)
    out = extrapolate.constant_extrapolate(T(f), T(in_u), n_sweeps=64)
    assert float(torch.max(torch.abs(out - 3.5))) < 1e-12
    close(out, jext.constant_extrapolate(jnp.asarray(f), jnp.asarray(in_u), 64))


def test_div_free_extrapolation():
    g, U0, V0, in_u, in_v = setup()
    s0 = sync.count
    U, V, rel, iters = extrapolate.div_free_extrapolate(T(U0), T(V0), T(in_u), T(in_v), g, tol=1e-11)
    assert sync.count - s0 == iters + 1 and float(rel) < 1e-10
    # the known faces are untouched
    assert float(torch.max(torch.abs(torch.where(T(in_u), U - T(U0), 0.0)))) == 0.0
    assert float(torch.max(torch.abs(torch.where(T(in_v), V - T(V0), 0.0)))) == 0.0
    # every interior cell with an unknown face is now divergence-free
    outside = outside_mask(g, 0.2)
    before = stencil.divergence(T(U0), T(V0), g.dx, g.dy)
    after = stencil.divergence(U, V, g.dx, g.dy)
    assert float(torch.max(torch.abs(torch.where(outside, before, 0.0)))) > 1.0
    assert float(torch.max(torch.abs(torch.where(outside, after, 0.0)))) < 1e-9

    jg = jmake_grid(0.0, 1.0, 24, 0.0, 1.0, 24)
    jU, jV, jrel, jiters = jext.div_free_extrapolate(jnp.asarray(U0), jnp.asarray(V0),
                                                     jnp.asarray(in_u), jnp.asarray(in_v), jg,
                                                     tol=1e-11)
    close(U, jU)
    close(V, jV)
    assert abs(iters - int(jiters)) <= 1


@pytest.mark.parametrize("n", [32])
def test_div_free_extrapolation_sealed(n):
    """Sealed boundary: the singular path; the divergence drops to the
    uniform incompatibility of the known data."""
    g, U0, V0, in_u, in_v = setup(n)
    n_sweeps = max(U0.shape)
    U_ext = extrapolate.constant_extrapolate(T(U0), T(in_u), n_sweeps)
    V_ext = extrapolate.constant_extrapolate(T(V0), T(in_v), n_sweeps)
    U, V, rel, iters = extrapolate.project_div_free(U_ext, V_ext, T(in_u), T(in_v), g, tol=1e-11,
                                                    max_iter=4000, seal_boundary=True)
    # the projection pins the boundary faces
    assert float(torch.max(torch.abs(U[1, 1:-1] - U_ext[1, 1:-1]))) == 0.0
    assert float(torch.max(torch.abs(U[-2, 1:-1] - U_ext[-2, 1:-1]))) == 0.0
    div = stencil.divergence(U, V, g.dx, g.dy)
    assert float(torch.max(torch.abs(torch.where(outside_mask(g, 0.25), div, 0.0)))) < 0.2

    jg = jmake_grid(0.0, 1.0, n, 0.0, 1.0, n)
    jU_ext = jext.constant_extrapolate(jnp.asarray(U0), jnp.asarray(in_u), n_sweeps)
    jV_ext = jext.constant_extrapolate(jnp.asarray(V0), jnp.asarray(in_v), n_sweeps)
    close(U_ext, jU_ext)
    close(V_ext, jV_ext)
    jU, jV, _, jiters = jext.project_div_free(jU_ext, jV_ext, jnp.asarray(in_u), jnp.asarray(in_v),
                                              jg, tol=1e-11, max_iter=4000, seal_boundary=True)
    close(U, jU)
    close(V, jV)
    assert abs(iters - int(jiters)) <= 2
