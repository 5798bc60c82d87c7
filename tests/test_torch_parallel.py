"""The port's x-slab mesh (``parallel/mesh.py``, ``parallel/halo.py``) and
the mesh step ``twophase.make_step(mesh=)`` against the JAX package on the
JAX tests' eight-device CPU mesh, with ``SlabMesh(["cpu"] * 8)``, in f64.

The mesh step is held to the JAX package's mesh step at the flagship's
own pressure tolerance (1e-6): both packages solve with the same BoxMG
hierarchy (the gathered levels end in the dense coarsest inverse in f64),
so they take the same PCG iterations (53) and vf, U, V, p agree to 1e-12
of their largest values (measured 7.5e-15 at most). It is also held to the
port's single-device step: the same PCG iterations and host reads, the
fields equal to rounding.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

try:
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

import __graft_entry__ as entrymod
import oracle
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.parallel import halo as jhalo
from fluidsolver_tpu.solvers import twophase as jtwophase
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.parallel import halo, mesh
from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
from fluidsolver_tpu_torch.solvers import incomp, twophase
from fluidsolver_tpu_torch.solvers.config import config_from_jax

torch.set_num_threads(1)
N_DEV = 8
MESH = SlabMesh(["cpu"] * N_DEV)


def jmesh():
    return Mesh(np.array(jax.devices()[:N_DEV]), ("x",))


def T(a):
    return torch.as_tensor(np.array(a))


def test_slab_mesh_collectives():
    """extend_x with zero rows at the mesh edges, the gather and scatter
    round trip, psum and pmax in rank order on the first device."""
    rng = np.random.default_rng(0)
    full = T(rng.normal(size=(N_DEV * 4, 5)))
    slabs = mesh.scatter_rows(MESH, full, 4)
    assert torch.equal(mesh.all_gather_rows(MESH, slabs), full)
    ext = mesh.extend_x(MESH, slabs, 2)
    padded = torch.cat([full.new_zeros(2, 5), full, full.new_zeros(2, 5)])
    for i, e in enumerate(ext):
        assert torch.equal(e, padded[4 * i:4 * i + 8])
    with pytest.raises(ValueError, match="wider"):
        mesh.extend_x(MESH, slabs, 5)
    sums = [s.sum() for s in slabs]
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    assert torch.equal(halo.psum_scalar(MESH, sums), total)
    assert torch.equal(halo.pmax_scalar(MESH, sums), torch.stack(sums).max())
    assert MESH.shape["x"] == len(MESH) == N_DEV


@pytest.mark.parametrize("periodic", [False, True])
def test_halo_exchange_matches_jax(periodic):
    nxl, ny = 4, 6
    blocks = np.random.default_rng(0).normal(size=(N_DEV * (nxl + 2), ny))
    fn = shard_map(lambda f: jhalo.halo_exchange_x(f, "x", periodic=periodic), mesh=jmesh(),
                   in_specs=P("x"), out_specs=P("x"), check_vma=False)
    want = np.asarray(fn(jnp.asarray(blocks)))
    got = halo.halo_exchange_x(MESH, mesh.scatter_rows(MESH, T(blocks), nxl + 2), periodic=periodic)
    assert np.array_equal(mesh.all_gather_rows(MESH, got).numpy(), want)


def test_distributed_jacobi_matches_jax():
    """The Jacobi skeleton (all-Neumann 30 x 8 box, 8 slabs of 4 rows with
    ghost rows) against the JAX package's, 300 sweeps: to 1e-12."""
    nx, ny = 30, 8
    g = jmake_grid(0.0, 1.0, nx, 0.0, 1.0, ny)
    coeffs = oracle.assemble_poisson(nx, ny, np.ones(g.shape_u), np.ones(g.shape_v), g.dx, g.dy)
    b = np.random.default_rng(1).normal(size=g.shape_center)
    b -= b.mean()
    nxl = (nx + 2) // N_DEV

    def slabify(arr):
        padded = np.pad(arr, ((1, 1), (0, 0)))
        return np.concatenate([padded[d * nxl:d * nxl + nxl + 2] for d in range(N_DEV)])

    args = [slabify(np.asarray(c)) for c in coeffs] + [slabify(b), slabify(np.zeros_like(b))]
    jx, jres = jhalo.make_distributed_jacobi_poisson(jmesh(), nxl, ny, n_iter=300)(
        *[jnp.asarray(a) for a in args])
    x, res = halo.make_distributed_jacobi_poisson(MESH, nxl, ny, n_iter=300)(*[T(a) for a in args])
    np.testing.assert_allclose(x.numpy(), np.asarray(jx), rtol=0.0, atol=1e-12)
    assert abs(float(res) - float(jres)) <= 1e-12 * float(jres)


def flagship(**kw):
    """The JAX tests' flagship drop at n=48 (refresh "step") and its port."""
    g, cfg, state, _ = entrymod._flagship(n=48)
    cfg = dataclasses.replace(cfg, **kw)
    grid = make_grid(g.x_min, g.x_max, g.nx, g.y_min, g.y_max, g.ny)
    return (g, cfg, state), (grid, config_from_jax(cfg), twophase.two_phase_state_from_numpy(state, "cpu"))


def counted_step(step, state):
    before = sync.count
    out = step(state, 1.0)
    return out, sync.count - before


@pytest.fixture(scope="module")
def flagship_steps():
    """One flagship step on the port's single device and on the mesh, each
    with its count of host reads."""
    flag = flagship()
    _, (grid, tcfg, tstate) = flag
    single = counted_step(twophase.make_step(grid, tcfg, torch.float64, "cpu"), tstate)
    meshed = counted_step(twophase.make_step(grid, tcfg, torch.float64, "cpu", mesh=MESH), tstate)
    return flag, single, meshed


def test_mesh_step_matches_jax_mesh_step(flagship_steps):
    """One flagship step on the mesh against the JAX package's mesh step:
    vf, U, V, p to 1e-12 relative, the same PCG iterations, which are also
    the port's single-device step's."""
    ((g, cfg, state), _), (single, _), (got, _) = flagship_steps
    want = jtwophase.make_step(g, cfg, mesh=jmesh())(state, 1.0)
    for a, b in ((got.vf, want.vf), (got.flow.U, want.flow.U), (got.flow.V, want.flow.V), (got.flow.p, want.flow.p)):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-12 * np.abs(b).max()
    assert int(got.flow.p_iter) == int(want.flow.p_iter) == int(single.flow.p_iter)


def test_mesh_step_matches_single_device_step(flagship_steps):
    """At the flagship's own tolerance (1e-6): the same iterations and host
    reads as the port's single-device step, the fields equal to rounding;
    ``make_fixed_runner(mesh=)`` takes the same two steps."""
    (_, (grid, tcfg, tstate)), (single, n_single), (got, n_mesh) = flagship_steps
    assert int(got.flow.p_iter) == int(single.flow.p_iter) and n_mesh == n_single
    assert torch.equal(got.vf, single.vf)
    for name in ("U", "V", "p"):
        a, b = getattr(got.flow, name), getattr(single.flow, name)
        assert float((a - b).abs().max()) <= 1e-12 * float(b.abs().max()), name
    two = twophase.make_fixed_runner(grid, tcfg, 2, torch.float64, "cpu", mesh=MESH)(tstate, 1.0)
    step = twophase.make_step(grid, tcfg, torch.float64, "cpu", mesh=MESH)
    assert torch.equal(two.flow.p, step(step(tstate, 1.0), 1.0).flow.p)


@pytest.mark.parametrize("option", [dict(vof_max_active=0), dict(vof_staggered_backtrace=True)])
def test_mesh_step_dense_advection(option):
    """Where the sharded advection does not apply (the dense budget, the
    staggered trace) the mesh step advects densely, as the JAX package's
    does: two_phase_channel(16) on 4 slabs against the single-device step
    with the dense advection."""
    case = get_case("two_phase_channel", ny=16)
    cfg = dataclasses.replace(case.cfg, pressure_tol=1e-11, **option)
    state = case.make_state(torch.float64, "cpu")
    dense = dataclasses.replace(cfg, vof_max_active=0)
    want = twophase.make_step(case.grid, dense, torch.float64, "cpu")(state, 1.0)
    got = twophase.make_step(case.grid, cfg, torch.float64, "cpu", mesh=SlabMesh(["cpu"] * 4))(state, 1.0)
    assert torch.equal(got.vf, want.vf)
    assert float((got.flow.U - want.flow.U).abs().max()) <= 1e-9 * float(want.flow.U.abs().max())


def test_mesh_pressure_solve_raises_for_other_methods():
    _, (grid, tcfg, tstate) = flagship(pressure_method="bicgstab")
    div = torch.zeros_like(tstate.flow.p)
    with pytest.raises(ValueError, match="supports pressure_method='pcg' only"):
        incomp.pressure_solve(tstate.flow, div, 1e-3, grid, tcfg, mesh=MESH)
    with pytest.raises(ValueError, match="first device"):
        twophase.make_step(grid, tcfg, torch.float64, "cpu", mesh=SlabMesh(["meta"] * 2))
