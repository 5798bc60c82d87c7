"""The port's BiCGSTAB, GMRES and MG-as-solver (``poisson/krylov.py``),
the dense direct solve (``poisson/direct.py``) and the single-phase step on
every pressure method and solver, against the JAX package in f64 on the
CPU (tests/test_krylov.py's systems).

The solvers run to tol 1e-11, where their iterates agree with the JAX
package's to 1e-8 of max|x|. Iteration counts agree within 3, or within
10% for the weakly preconditioned runs of several hundred iterations on
the 1000:1 random checkerboard, where the order of the sums moves the
count. With "boxmg" both packages solve these boxes with the stock
hierarchy, whose only level is small enough for the dense inverse: the
counts are equal and the iterates agree to 1e-12 of max|x| (measured
6.4e-14 at most), and the channel's fields to 1e-12 (measured 1.3e-13).
MG-as-solver runs at 1:1: the stationary PC-Galerkin V-cycle ("mg")
stalls at 1000:1 (test_krylov.py).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.core import bc as jbc
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.poisson import cg as jcg
from fluidsolver_tpu.poisson import direct as jdirect
from fluidsolver_tpu.poisson import krylov as jkrylov
from fluidsolver_tpu.poisson import linsys as jlin
from fluidsolver_tpu.solvers import incomp as jincomp
from fluidsolver_tpu.solvers.config import SolverConfig as JSolverConfig
from fluidsolver_tpu.solvers.state import init_flow_state as jinit_flow_state
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.poisson import cg, direct, krylov
from fluidsolver_tpu_torch.poisson.linsys import StencilOp, apply_op
from fluidsolver_tpu_torch.solvers import incomp
from fluidsolver_tpu_torch.solvers.config import config_from_jax
from fluidsolver_tpu_torch.solvers.state import state_from_numpy

torch.set_num_threads(1)
TOL = 1e-8
# the stock BoxMG hierarchy's bound: both packages invert the same coarsest level
BOXMG_TOL = 1e-12
SOLVERS = ("bicgstab", "gmres", "mgsolve")
PRECONDS = ("none", "jacobi", "boxmg", "mg")


def T(a):
    return torch.as_tensor(np.array(a))


def port_op(jop):
    return StencilOp(**{f.name: T(getattr(jop, f.name)) for f in dataclasses.fields(jop)})


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def system(pin=None, ratio=1000.0, seed=11):
    """test_krylov.py's system: a 12 x 9 grid (14 x 11 box) with 1 / ratio
    face densities at random and a normal right-hand side, zero on the
    ghost ring."""
    rng = np.random.default_rng(seed)
    g = jmake_grid(0.0, 1.0, 12, 0.0, 0.7, 9)
    rho_u = np.where(rng.random(g.shape_u) > 0.5, ratio, 1.0)
    rho_v = np.where(rng.random(g.shape_v) > 0.5, ratio, 1.0)
    jop = jlin.assemble_pressure_operator(jnp.asarray(rho_u), jnp.asarray(rho_v), g.dx, g.dy, pin)
    b = rng.normal(size=g.shape_center)
    b[0, :] = b[-1, :] = b[:, 0] = b[:, -1] = 0.0
    return jop, b


@functools.lru_cache(maxsize=None)
def _jax_solver(method, precond, **kw):
    """The JAX package's solve with a V(2,2) preconditioner, under jit (one
    compile per method, preconditioner and keywords)."""
    jsolve = {"bicgstab": jkrylov.solve_bicgstab, "gmres": jkrylov.solve_gmres,
              "mgsolve": jkrylov.solve_mg}[method]

    def run(op, b, x0):
        M_inv, _ = jcg.make_m_inv(op, b.dtype, precond, n_pre=2, n_post=2)
        return jsolve(op, b, M_inv=M_inv, x0=x0, **kw)

    return jax.jit(run)


def solve_both(method, precond, jop, b, x0=None, **kw):
    """The JAX package's solve and the port's on the same inputs."""
    solve = {"bicgstab": krylov.solve_bicgstab, "gmres": krylov.solve_gmres,
             "mgsolve": krylov.solve_mg}[method]
    jx, jrel, jit = _jax_solver(method, precond, **kw)(
        jop, jnp.asarray(b), None if x0 is None else jnp.asarray(x0))
    op = port_op(jop)
    M_inv, _ = cg.make_m_inv(op, precond, n_pre=2, n_post=2)
    x, rel, it = solve(op, T(b), M_inv=M_inv, x0=None if x0 is None else T(x0), **kw)
    return (np.asarray(jx), float(jrel), int(jit)), (x, float(rel), it)


CASES = [(m, p, pin) for m in SOLVERS for p in PRECONDS for pin in (None, "right")
         if not (m == "mgsolve" and p in ("none", "jacobi"))]


@pytest.mark.parametrize("method,precond,pin", CASES)
def test_solver_matches_jax(method, precond, pin):
    jop, b = system(pin=pin, ratio=1.0 if method == "mgsolve" else 1000.0)
    kw = dict(tol=1e-11, max_iter=600, singular=pin is None)
    if method == "gmres":
        # weakly preconditioned restarted GMRES stalls on the 1000:1 jumps;
        # a restart of n is exact in one cycle (test_krylov.py)
        kw["restart"] = b.size if precond in ("none", "jacobi") else 30
        kw["max_iter"] = max(kw["max_iter"], b.size + 1)
    (jx, jrel, jit), (x, rel, it) = solve_both(method, precond, jop, b, **kw)
    assert rel < 1e-11 and jrel < 1e-11, (rel, jrel)
    op = port_op(jop)
    bp = T(b) - T(b).mean() if pin is None else T(b)
    assert float(torch.linalg.norm(bp - apply_op(op, x)) / torch.linalg.norm(bp)) < 1e-10
    if pin is None:
        assert abs(float(x.mean())) < 1e-12
    if precond == "boxmg":
        assert max_rel(x, jx) <= BOXMG_TOL and it == jit, (max_rel(x, jx), it, jit)
    assert max_rel(x, jx) <= TOL, max_rel(x, jx)
    assert abs(it - jit) <= max(3, jit // 10), (it, jit)


@pytest.mark.parametrize("method", SOLVERS)
def test_warm_starts_match_jax(method):
    """A guess that solves the system ends the solve in at most one
    iteration; a guess 1e6 x ones is discarded and the solve runs as from
    zero. Pinned left, "mg" preconditioner (1:1 for MG-as-solver)."""
    jop, b = system(pin="left", ratio=1.0 if method == "mgsolve" else 1000.0)
    kw = dict(tol=1e-11, max_iter=300, singular=False)
    (jx, _, jit), (x, _, it) = solve_both(method, "mg", jop, b, **kw)
    (jxw, jrelw, jitw), (xw, relw, itw) = solve_both(method, "mg", jop, b, x0=jx, **kw)
    assert itw <= 1 and jitw <= 1 and relw < 1e-11 and jrelw < 1e-11
    assert max_rel(xw, jxw) <= TOL
    (jxb, _, jitb), (xb, _, itb) = solve_both(method, "mg", jop, b, x0=1e6 * np.ones_like(b), **kw)
    assert abs(itb - jitb) <= 3 and itb == it and max_rel(xb, jxb) <= TOL and torch.equal(xb, x)


def test_zero_rhs_short_circuits():
    jop, b = system()
    op = port_op(jop)
    M_inv, _ = cg.make_m_inv(op, "boxmg")
    zero = torch.zeros_like(T(b))
    for solve in (krylov.solve_bicgstab, krylov.solve_gmres, krylov.solve_mg):
        x, rel, it = solve(op, zero, tol=1e-8, max_iter=50, singular=True, M_inv=M_inv,
                           x0=torch.ones_like(zero))
        assert it == 0 and float(x.abs().max()) == 0.0 and float(rel) == 0.0


# ---- the dense direct solve ----------------------------------------------------
@pytest.mark.parametrize("pin", [None, "right"])
def test_direct_matches_jax(pin):
    jop, b = system(pin=pin)
    op = port_op(jop)
    np.testing.assert_array_equal(direct.dense_matrix(op).numpy(), np.asarray(jdirect.dense_matrix(jop)))
    want = jdirect.solve_direct(jop, jnp.asarray(b), pin is None)
    got = direct.solve_direct(op, T(b), pin is None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0.0, atol=1e-10)


# ---- the single-phase step on every pressure method and solver --------------------
def channel_config(**kw):
    """test_krylov.py's channel (32 x 8, uniform inflow, outflow
    correction) at pressure tol 1e-12."""
    return JSolverConfig(
        rho_gas=1.0, rho_liquid=1.0, visc_gas=1e-3, visc_liquid=1e-3, cfl_max=0.9, dt_max=5e-2,
        num_subiter=2, pressure_tol=1e-12, pressure_max_iter=200,
        bcs=jbc.FlowBCs(jbc.Dirichlet(u=1.0, v=0.0), jbc.Neumann(), jbc.Dirichlet(u=0.0, v=0.0),
                        jbc.Dirichlet(u=0.0, v=0.0)),
        outflow_correction=True, **kw)


@pytest.mark.parametrize("method,solver", [("bicgstab", "boxmg"), ("gmres", "boxmg"),
                                           ("mgsolve", "mg"), ("pcg", "mg"),
                                           ("pcg", "jacobi"), ("pcg", "direct")])
def test_channel_step_matches_jax(method, solver):
    """3 steps of the channel against the JAX package's step, U, V, p held
    to 1e-8 relative, to 1e-12 and the same iteration count with "boxmg"
    (the dense inverse in both packages)."""
    jcfg = channel_config(pressure_method=method, pressure_solver=solver)
    jg = jmake_grid(0.0, 4.0, 32, 0.0, 1.0, 8)
    jstate = jinit_flow_state(jg, jcfg.rho_gas, jcfg.visc_gas)
    jstate = dataclasses.replace(jstate, U=jnp.ones_like(jstate.U), U_old=jnp.ones_like(jstate.U))
    state = state_from_numpy(jstate, "cpu")
    grid = make_grid(jg.x_min, jg.x_max, jg.nx, jg.y_min, jg.y_max, jg.ny)
    jstep = jincomp.make_step(jg, jcfg)
    step = incomp.make_step(grid, config_from_jax(jcfg), torch.float64, "cpu")
    assert (step.levels is None) == (solver not in ("mg", "boxmg"))
    for _ in range(3):
        jstate = jstep(jstate, 10.0)
        state = step(state, 10.0)
        assert float(state.t) == pytest.approx(float(jstate.t), rel=1e-14)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= (BOXMG_TOL if solver == "boxmg" else TOL), k
        if solver == "boxmg":
            assert int(state.p_iter) == int(jstate.p_iter)
    if solver == "direct":
        assert int(state.p_iter) == jcfg.num_subiter and float(state.p_res) == 0.0


def test_unsupported_pressure_configs_raise():
    """MG-as-solver needs a V-cycle; a preconditioner dtype must be a float
    dtype's name."""
    grid = make_grid(0.0, 1.0, 8, 0.0, 1.0, 8)
    for kw in (dict(pressure_method="mgsolve", pressure_solver="jacobi"),
               dict(pressure_precond_dtype="bf8"), dict(pressure_solver="ilu"),
               dict(pressure_method="cgs")):
        cfg = config_from_jax(channel_config(**kw))
        with pytest.raises(ValueError):
            incomp.make_step(grid, cfg, torch.float64, "cpu")


@pytest.mark.parametrize("method,solver", [("bicgstab", "boxmg"), ("gmres", "mg"),
                                           ("mgsolve", "boxmg")])
def test_channel_step_bf16_preconditioner_matches_jax(method, solver):
    """The channel's 3 steps with ``pressure_precond_dtype="bfloat16"``:
    BiCGSTAB, GMRES and MG-as-solver take the bf16 V-cycle (cast back to
    f64) as their M_inv, and U, V, p stay within 1e-8 of the JAX
    package's step, as in f32. (BiCGSTAB stops on its breakdown guard near
    1e-10 in both packages, after 3-8 iterations a step; fields within
    3.1e-10.)"""
    jcfg = channel_config(pressure_method=method, pressure_solver=solver,
                          pressure_precond_dtype="bfloat16")
    jg = jmake_grid(0.0, 4.0, 32, 0.0, 1.0, 8)
    jstate = jinit_flow_state(jg, jcfg.rho_gas, jcfg.visc_gas)
    jstate = dataclasses.replace(jstate, U=jnp.ones_like(jstate.U), U_old=jnp.ones_like(jstate.U))
    state = state_from_numpy(jstate, "cpu")
    grid = make_grid(jg.x_min, jg.x_max, jg.nx, jg.y_min, jg.y_max, jg.ny)
    jstep = jincomp.make_step(jg, jcfg)
    step = incomp.make_step(grid, config_from_jax(jcfg), torch.float64, "cpu")
    lv0 = step.levels[0]
    assert (lv0.op.aC if solver == "boxmg" else lv0.aC).dtype == torch.bfloat16
    for _ in range(3):
        jstate = jstep(jstate, 10.0)
        state = step(state, 10.0)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= TOL, k
