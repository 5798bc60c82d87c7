"""The port's geometric multigrid (``poisson/mg.py``), its red-black sweep
kernel's twin (``poisson/cuda_smoother.py``), PCG with the "mg", "jacobi"
and "none" preconditioners, and the two-phase step on "mg", against the
JAX package in f64 on the CPU.

The sweep's twin follows the JAX package's XLA sweep (``mg._rb_sweep``)
operation for operation and is held to it and to the Pallas kernel in
interpret mode at 1e-12 (tests/test_pallas_smoother.py's bound; the Pallas
kernel sums the off-diagonal terms directly, so it differs by rounding).
The multigrid algebra is held at 1e-13 and a V-cycle at 1e-12 of its
largest value; solves and steps at 1e-8 relative, with iteration counts
within 3 (test_torch_fused.py's slack).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.poisson import cg as jcg
from fluidsolver_tpu.poisson import linsys as jlin
from fluidsolver_tpu.poisson import mg as jmg
from fluidsolver_tpu.poisson import pallas_smoother
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.poisson import cg, cuda_smoother, mg
from fluidsolver_tpu_torch.poisson.linsys import StencilOp

torch.set_num_threads(1)
TOL = 1e-8


def T(a):
    return torch.as_tensor(np.array(a))


def port_op(jop):
    return StencilOp(**{f.name: T(getattr(jop, f.name)) for f in dataclasses.fields(jop)})


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def jump_operator(nx, ny, seed=5, pin=None):
    """The JAX operator of an nx x ny grid with 1 / 1000 face densities at
    random (test_pallas_smoother.py's)."""
    rng = np.random.default_rng(seed)
    g = jmake_grid(0.0, 1.0, nx, 0.0, 1.0, ny)
    rho_u = jnp.asarray(np.where(rng.random(g.shape_u) > 0.5, 1000.0, 1.0))
    rho_v = jnp.asarray(np.where(rng.random(g.shape_v) > 0.5, 1000.0, 1.0))
    return jlin.assemble_pressure_operator(rho_u, rho_v, g.dx, g.dy, pin)


def drop_operator(n, pin=None, ratio=1000.0):
    """The JAX operator of a drop (r = 0.25, density ``ratio``) in an n^2
    grid (test_poisson.py's _drop_system)."""
    g = jmake_grid(0.0, 1.0, n, 0.0, 1.0, n)
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    Xv, Yv = np.meshgrid(g.xm, g.y, indexing="ij")
    rho_u = np.where((Xu - 0.5) ** 2 + (Yu - 0.5) ** 2 < 0.25**2, ratio, 1.0)
    rho_v = np.where((Xv - 0.5) ** 2 + (Yv - 0.5) ** 2 < 0.25**2, ratio, 1.0)
    return jlin.assemble_pressure_operator(jnp.asarray(rho_u), jnp.asarray(rho_v), g.dx, g.dy, pin)


def fields(shape, seed, n=2):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(n)]


# ---- kernel 9: the red-black sweep ---------------------------------------------
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("grid,zero_diag", [((30, 22), False), ((31, 19), False), ((31, 19), True)])
def test_rb_sweep_twin_matches_jax(grid, zero_diag, reverse):
    """32 x 24 (test_pallas_smoother.py's box) and an odd 33 x 21 box, the
    latter also with some aC = 0 (the guard divides by 1)."""
    jop = jump_operator(*grid)
    if zero_diag:
        jop = dataclasses.replace(jop, aC=jop.aC.at[3, 4].set(0.0).at[10:12, 7].set(0.0))
    x, b = fields(jop.aC.shape, 7)
    level = jmg.MGLevel(op=jop, red=jmg._checkerboard(jop.aC.shape, jop.aC.dtype))
    xla = jmg._rb_sweep(level, jnp.asarray(x), jnp.asarray(b), reverse=reverse)
    pallas = pallas_smoother.rb_sweep_pallas(jop, jnp.asarray(x), jnp.asarray(b), reverse=reverse,
                                             interpret=True)
    got = cuda_smoother.rb_sweep(port_op(jop), T(x), T(b), reverse)
    np.testing.assert_array_equal(got.numpy(), np.asarray(xla))
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=1e-12, atol=1e-12)


# ---- the multigrid algebra -------------------------------------------------------
@pytest.mark.parametrize("grid", [(30, 22), (31, 19)])
def test_galerkin_and_transfers_match_jax(grid):
    jop = jump_operator(*grid, seed=9)
    op = port_op(jop)
    close = functools.partial(np.testing.assert_allclose, rtol=1e-13, atol=1e-13)
    jc, c = jmg.galerkin_coarsen(jop), mg.galerkin_coarsen(op)
    for f in ("aC", "aL", "aR", "aB", "aT"):
        close(getattr(c, f).numpy(), np.asarray(getattr(jc, f)), err_msg=f)
    shape = jop.aC.shape
    r, _ = fields(shape, 11)
    e, _ = fields(jc.aC.shape, 13)
    close(mg.restrict_pc(T(r)).numpy(), np.asarray(jmg.restrict_pc(jnp.asarray(r))))
    close(mg.prolong_pc(T(e), shape).numpy(), np.asarray(jmg.prolong_pc(jnp.asarray(e), shape)))
    close(mg.restrict_bilinear(T(r)).numpy(), np.asarray(jmg.restrict_bilinear(jnp.asarray(r))))
    close(mg.prolong_bilinear(T(e), shape).numpy(),
          np.asarray(jmg.prolong_bilinear(jnp.asarray(e), shape)))
    close(mg.restrict_oi(op, T(r)).numpy(), np.asarray(jmg.restrict_oi(jop, jnp.asarray(r))))
    close(mg.prolong_oi(op, T(e), shape).numpy(),
          np.asarray(jmg.prolong_oi(jop, jnp.asarray(e), shape)))


@pytest.mark.parametrize("shape", [(1026, 1026), (1023, 771), (34, 34), (82, 18)])
def test_hierarchy_shapes_match_jax(shape):
    """Level shapes from the finest shape alone (no values: JAX traces the
    build abstractly, the port builds on the meta device). The bench box
    has 10 levels, so a V(2,2) cycle is 9 x 4 + 16 = 52 sweeps."""
    jshape = jax.ShapeDtypeStruct(shape, jnp.float64)
    jlevels = jax.eval_shape(jmg.build_hierarchy, jlin.StencilOp(*(jshape,) * 5))
    levels = mg.build_hierarchy(StencilOp(*(torch.empty(shape, device="meta"),) * 5))
    assert [tuple(lv.aC.shape) for lv in levels] == [tuple(lv.op.aC.shape) for lv in jlevels]
    if shape == (1026, 1026):
        assert [lv.aC.shape[0] for lv in levels] == [1026, 513, 257, 129, 65, 33, 17, 9, 5, 3]
        assert (len(levels) - 1) * (2 + 2) + mg.COARSE_SWEEPS == 52


@pytest.mark.parametrize("transfers", ["pc", "bilinear", "oi"])
def test_v_cycle_matches_jax(transfers):
    """One V(2,2) cycle on the 1000:1 drop at 32^2 (test_poisson.py's
    system), hierarchy and cycle against the JAX package's."""
    jop = drop_operator(32)
    b, _ = fields(jop.aC.shape, 17)
    jlevels = jmg.build_hierarchy(jop)
    want = jax.jit(functools.partial(jmg.v_cycle, n_pre=2, n_post=2, transfers=transfers))(
        jlevels, jnp.asarray(b))
    got = mg.v_cycle(mg.build_hierarchy(port_op(jop)), T(b), n_pre=2, n_post=2, transfers=transfers)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0,
                               atol=1e-12 * float(jnp.abs(want).max()))
    with pytest.raises(ValueError):
        mg.v_cycle(mg.build_hierarchy(port_op(jop)), T(b), transfers="cubic")


# ---- PCG with every preconditioner of cg.make_m_inv --------------------------------
def _rhs(jop, pin, seed):
    b, _ = fields(jop.aC.shape, seed)
    if pin is None:
        return b - b.mean()
    b[-1, :] = 0.0
    return b


@pytest.mark.parametrize("pin", [None, "right"])
@pytest.mark.parametrize("precond", ["mg", "jacobi", "none"])
def test_solve_pcg_matches_jax(precond, pin):
    """PCG on the 32^2 drop at tol 1e-10, singular or pinned, against the
    JAX package's solve: x within 1e-8 of max|x|, iterations within 3.
    Unpreconditioned CG takes ~1000 iterations at 1000:1, where the order
    of the sums moves the count by up to ~15: it runs at 10:1."""
    jop = drop_operator(32, pin, ratio=10.0 if precond == "none" else 1000.0)
    b = _rhs(jop, pin, 19)
    kw = dict(tol=1e-10, max_iter=2000, singular=pin is None, precond=precond)
    jx, jrel, jit = jax.jit(functools.partial(jcg.solve_pcg, **kw))(jop, jnp.asarray(b))
    x, rel, it = cg.solve_pcg(port_op(jop), T(b), **kw)
    assert float(rel) < 1e-10 and float(jrel) < 1e-10
    assert abs(it - int(jit)) <= 3, (it, int(jit))
    assert max_rel(x, jx) <= TOL


def test_solve_pcg_default_preconditioner_is_mg():
    """Called without ``precond``, both packages precondition with "mg"
    and reach the same iterate."""
    jop = drop_operator(32)
    b = _rhs(jop, None, 23)
    kw = dict(tol=1e-10, max_iter=200, singular=True)
    jx, _, jit = jax.jit(functools.partial(jcg.solve_pcg, **kw))(jop, jnp.asarray(b))
    x, _, it = cg.solve_pcg(port_op(jop), T(b), **kw)
    assert it == int(jit) and max_rel(x, jx) <= TOL
    x_mg, _, _ = cg.solve_pcg(port_op(jop), T(b), precond="mg", **kw)
    assert torch.equal(x, x_mg)


def test_make_m_inv_surface():
    op = port_op(jump_operator(10, 8))
    r = T(fields(op.aC.shape, 29)[0])
    M, levels = cg.make_m_inv(op, "jacobi")
    assert levels is None and torch.equal(M(r), r / op.aC)
    M, levels = cg.make_m_inv(op, "none")
    assert levels is None and M(r) is r
    M, levels = cg.make_m_inv(op, "mg")
    assert [tuple(lv.aC.shape) for lv in levels] == [(12, 10), (6, 5), (3, 3)]
    assert cg.build_precond_levels(op, "jacobi") is None
    with pytest.raises(ValueError):
        cg.make_m_inv(op, "ilu")


# ---- the two-phase step on "mg" ---------------------------------------------------------
@pytest.mark.parametrize("refresh", ["step", "solve"])
def test_two_phase_channel_mg_against_jax(refresh):
    """two_phase_channel(ny=16) on PCG + "mg", 3 steps with cold-started
    solves, against the JAX package's step (test_torch_fused.py's case and
    bound)."""
    kw = dict(pressure_solver="mg", pressure_tol=1e-11, pressure_tol_intermediate=1e-9,
              pressure_precond_refresh=refresh, pressure_warm_start=False)
    jcase, tcase = jget_case("two_phase_channel", ny=16), get_case("two_phase_channel", ny=16)
    jcase.cfg = dataclasses.replace(jcase.cfg, **kw)
    tcase.cfg = dataclasses.replace(tcase.cfg, **kw)
    jstate, state = jcase.make_state(np.float64), tcase.make_state(torch.float64, "cpu")
    jstep, step = jcase.make_step(), tcase.make_step(torch.float64, "cpu")
    for _ in range(3):
        jstate = jstep(jstate, jcase.t_end)
        state = step(state, tcase.t_end)
        assert float(state.flow.t) == pytest.approx(float(jstate.flow.t), rel=1e-14)
        assert abs(int(state.flow.p_iter) - int(jstate.flow.p_iter)) <= 3
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state.flow, k), getattr(jstate.flow, k)) <= TOL, k
        for k in ("vf", "curv", "interface_length"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= TOL, k
