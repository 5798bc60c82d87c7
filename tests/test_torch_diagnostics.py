"""The port's diagnostics and debug helpers against the JAX package, in
f64 on the CPU, on the same seeded numpy inputs: the ghost-ring helpers of
``core/fields.py``, ``ops.stencil.l1_norm``,
``ops.momentum.conserved_quantities`` (to 1e-13 relative),
``poisson.boxmg.galerkin_boxmg`` (the comb-probing oracle of
``galerkin_closed``, to atol 1e-12 against both) and ``stride2`` (equal);
and the ``FS_NAN_POISON=1`` scratch-NaN mode of tests/test_nan_poison.py
on the port alone.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.core import fields as jfields
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.ops import momentum as jmom
from fluidsolver_tpu.ops import stencil as jstencil
from fluidsolver_tpu.poisson import boxmg as jbox
from fluidsolver_tpu.poisson import linsys as jlin
from fluidsolver_tpu_torch.core import bc, fields
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.poisson import boxmg
from fluidsolver_tpu_torch.poisson.linsys import StencilOp
from fluidsolver_tpu_torch.solvers import twophase
from fluidsolver_tpu_torch.solvers.config import SolverConfig
from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator

torch.set_num_threads(1)
REL = 1e-13


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert np.abs(got - want).max() <= rel * (np.abs(want).max() or 1.0), (got, want)


def field(seed, shape=(14, 11)):
    return np.random.default_rng(seed).normal(size=shape)


@pytest.mark.parametrize("case", ["finite", "nan", "inf"])
def test_field_helpers_match_jax(case):
    f = field(1)
    if case != "finite":
        f[3, 4] = np.nan if case == "nan" else -np.inf
    t, j = T(f), jnp.asarray(f)
    inner = fields.interior(t)
    assert inner._base is t
    np.testing.assert_array_equal(inner.numpy(), np.asarray(jfields.interior(j)))
    flag = fields.has_nan_or_inf(t)
    assert flag.shape == () and flag.dtype == torch.bool and flag.device == t.device
    assert bool(flag) == bool(jfields.has_nan_or_inf(j)) == (case != "finite")
    if case == "finite":
        for name in ("abs_max", "fmax", "fmin"):
            close(getattr(fields, name)(t), getattr(jfields, name)(j))


@pytest.mark.parametrize("include_ghost", [False, True])
def test_l1_norm_matches_jax(include_ghost):
    f = field(2)
    close(stencil.l1_norm(T(f), 0.1, 0.07, include_ghost),
          jstencil.l1_norm(jnp.asarray(f), 0.1, 0.07, include_ghost))


@pytest.mark.parametrize("case", ["uniform", "random"])
def test_conserved_quantities_match_jax(case):
    """tests/test_momentum.py's uniform 8^2 case (mass 3, momenta 6 and -3)
    and random fields on a 12 x 9 grid."""
    if case == "uniform":
        g = jmake_grid(0.0, 1.0, 8, 0.0, 1.0, 8)
        U, V = np.full(g.shape_u, 2.0), np.full(g.shape_v, -1.0)
        rho_u, rho_v = np.full(g.shape_u, 3.0), np.full(g.shape_v, 3.0)
    else:
        g = jmake_grid(0.0, 1.2, 12, 0.0, 0.7, 9)
        rng = np.random.default_rng(3)
        U, V = rng.normal(size=g.shape_u), rng.normal(size=g.shape_v)
        rho_u, rho_v = 1.0 + rng.uniform(size=g.shape_u), 1.0 + rng.uniform(size=g.shape_v)
    got = mom.conserved_quantities(T(U), T(V), T(rho_u), T(rho_v), g.dx, g.dy)
    want = jmom.conserved_quantities(*map(jnp.asarray, (U, V, rho_u, rho_v)), g.dx, g.dy)
    assert all(q.shape == () for q in got)
    for a, b in zip(got, want):
        close(a, b)
    if case == "uniform":
        assert np.allclose([float(q) for q in got], [3.0, 6.0, -3.0], rtol=1e-14)


@pytest.mark.parametrize("shape", [(7, 5), (8, 6)])
def test_stride2(shape):
    a = field(4, shape)
    for i0 in (0, 1):
        for j0 in (0, 1):
            np.testing.assert_array_equal(boxmg.stride2(T(a), i0, j0).numpy(),
                                          np.asarray(jbox.stride2(jnp.asarray(a), i0, j0)))


def jump_operator(nx, ny, pin):
    """tests/test_poisson.py's two-phase system: 1 / 1000 face densities at
    random on an nx x ny grid."""
    rng = np.random.default_rng(nx * ny)
    g = jmake_grid(0.0, 1.0, nx, 0.0, 0.7, ny)
    rho_u = np.where(rng.random(g.shape_u) > 0.5, 1000.0, 1.0)
    rho_v = np.where(rng.random(g.shape_v) > 0.5, 1000.0, 1.0)
    return jlin.assemble_pressure_operator(jnp.asarray(rho_u), jnp.asarray(rho_v), g.dx, g.dy, pin)


def to_port(obj):
    cls = {"StencilOp": StencilOp, "Stencil9": boxmg.Stencil9, "BoxTransfer": boxmg.BoxTransfer}
    return cls[type(obj).__name__](**{f.name: T(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def to_jax(obj):
    cls = {"StencilOp": jlin.StencilOp, "Stencil9": jbox.Stencil9, "BoxTransfer": jbox.BoxTransfer}
    return cls[type(obj).__name__](**{f.name: jnp.asarray(getattr(obj, f.name).numpy())
                                      for f in dataclasses.fields(obj)})


@functools.lru_cache(maxsize=None)
def _jax_probe(shape):
    return jax.jit(functools.partial(jbox.galerkin_boxmg, fine_shape=shape))


@pytest.mark.parametrize("nx,ny,pin", [(10, 6, None), (9, 7, "right"), (31, 30, None)])
def test_galerkin_boxmg_matches_jax_and_closed_form(nx, ny, pin):
    """The shapes of tests/test_poisson.py::test_boxmg_closed_form_equals_probing,
    the 5-point operator and then its 9-point coarse operator: the port's
    probe against the JAX package's and against the port's closed form,
    atol 1e-12."""
    op = to_port(jump_operator(nx, ny, pin))
    for _ in range(2):  # 5-point, then 9-point
        shape = tuple(op.aC.shape)
        tr = boxmg.collapse_weights(op)
        probe = boxmg.galerkin_boxmg(op, tr, shape)
        closed = boxmg.galerkin_closed(op, tr, shape)
        jprobe = _jax_probe(shape)(to_jax(op), to_jax(tr))
        for n in boxmg.COEF_NAMES:
            np.testing.assert_allclose(getattr(probe, n).numpy(), np.asarray(getattr(jprobe, n)), rtol=0, atol=1e-12,
                                       err_msg=f"{shape} jax {n}")
            np.testing.assert_allclose(getattr(probe, n).numpy(), getattr(closed, n).numpy(), rtol=0, atol=1e-12,
                                       err_msg=f"{shape} closed {n}")
        op = probe


# ---- FS_NAN_POISON=1 (tests/test_nan_poison.py on the port) ----------------------
def _fluxes(n=12):
    rng = np.random.default_rng(3)
    U, V = T(rng.normal(size=(n + 3, n + 2))), T(rng.normal(size=(n + 2, n + 3)))
    rho_u, rho_v = T(1.0 + rng.uniform(size=(n + 3, n + 2))), T(1.0 + rng.uniform(size=(n + 2, n + 3)))
    visc, p = T(rng.uniform(size=(n + 2, n + 2))), T(rng.normal(size=(n + 2, n + 2)))
    dmom = mom.calc_dmomdt(U, V, rho_u, rho_v, visc, p, torch.zeros_like(rho_u), torch.zeros_like(rho_v),
                           0.1, 0.1, 1e-6)
    drho = mom.calc_drhodt(U, V, rho_u, rho_v, 0.1, 0.1, 1e-6)
    return dmom + drho


def test_unwritten_cell_trips_poison(monkeypatch):
    """The synthesized rings of calc_dmomdt and calc_drhodt are NaN, so a
    stencil or a sum that reads them trips; the interiors equal the
    unpoisoned ones bitwise."""
    monkeypatch.setenv("FS_NAN_POISON", "0")
    clean = _fluxes()
    monkeypatch.setenv("FS_NAN_POISON", "1")
    poisoned = _fluxes()
    for a, b in zip(clean, poisoned):
        ring = torch.ones_like(b, dtype=torch.bool)
        ring[1:-1, 1:-1] = False
        assert bool(torch.isnan(b[ring]).all()) and not bool(torch.isnan(a).any())
        assert torch.equal(a[1:-1, 1:-1], b[1:-1, 1:-1])
        assert bool(torch.isnan(0.5 * (b[:-1, :] + b[1:, :])).any()) and bool(torch.isnan(b.sum()))


def test_poisoned_solver_run_is_bit_identical(monkeypatch):
    """tests/test_nan_poison.py's 24^2 two-phase run to t = 0.1 under
    FS_NAN_POISON=1 equals the unpoisoned run on U, V, p and vf: no step
    reads a synthesized ring."""
    n = 24
    g = make_grid(0.0, 1.0, n, 0.0, 1.0, n)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=100.0, visc_gas=1e-3, visc_liquid=1e-2,
        sigma=0.02, cfl_max=0.5, dt_max=5e-2, num_subiter=2,
        pressure_tol=1e-8, pressure_max_iter=60, pressure_pin="right",
        bcs=bc.FlowBCs(bc.Neumann(), bc.Neumann(), bc.Neumann(), bc.Neumann()),
        gravity=(0.0, -1.0),
    )
    vf0 = liquid_fraction_from_indicator(lambda x, y: (x - 0.5) ** 2 + (y - 0.6) ** 2 <= 0.2**2, g)
    runs = {}
    for poison in ("0", "1"):
        monkeypatch.setenv("FS_NAN_POISON", poison)
        state = twophase.init_two_phase_state(g, cfg, vf0, torch.float64, "cpu")
        runs[poison] = twophase.run(state, 0.1, g, cfg)
    assert float(runs["1"].flow.t) == pytest.approx(0.1)
    for name in ("U", "V", "p"):
        a, b = getattr(runs["0"].flow, name), getattr(runs["1"].flow, name)
        assert not bool(torch.isnan(b[1:-1, 1:-1]).any()), name
        assert torch.equal(a[1:-1, 1:-1], b[1:-1, 1:-1]), name
    assert torch.equal(runs["0"].vf[1:-1, 1:-1], runs["1"].vf[1:-1, 1:-1])
