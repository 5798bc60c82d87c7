"""The port's fused composition (the JAX package's ``FS_PALLAS_CG=1``,
``FS_PALLAS_MOMENTUM=1``) against the JAX package, in f64 on the CPU, where
kernels 5-8 and 13 run their plain PyTorch twins.

The twins of ``step_ab``, ``step_c`` and ``step_init`` are held to the
Pallas kernels in interpret mode at the tolerances the JAX package holds
those kernels to its XLA loop body (tests/test_pallas_cg.py,
tests/test_padded_carry.py): the two reduce in different orders, so the
scalars agree to near-ulp relative tolerances. ``fused_momentum``'s twin is
held to the Pallas kernel at atol 1e-11 (densities) and 1e-12 (velocities),
as tests/test_pallas_momentum.py holds the kernel to the unfused sequence.
``fused_rhs``'s twin (kernel 13, no Pallas kernel) is held bitwise to the
subiteration's unfused sequence and to the JAX package's ``jnp`` RHS at
1e-14.
The port's solve and steps are held to the JAX package's plain ones at the
bounds of test_pallas_cg.py and test_torch_twophase.py, and make exactly
the kernel calls that chip_smoke.py counts on the card.
"""

import collections
import dataclasses
import functools
import gc
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu.core.fields import add_interior as jadd_interior
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.ops import momentum as jmom
from fluidsolver_tpu.ops import stencil as jstencil
from fluidsolver_tpu.ops.pallas_momentum import fused_momentum as jfused_momentum
from fluidsolver_tpu.poisson import cg as jcg
from fluidsolver_tpu.poisson import linsys as jlin
from fluidsolver_tpu.poisson import pallas_cg as pc
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import bc, fields
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ops import cuda_momentum, cuda_rhs, stencil
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.poisson import _kernels, cg, cuda_cg
from fluidsolver_tpu_torch.poisson.linsys import StencilOp
from fluidsolver_tpu_torch.solvers import twophase
from fluidsolver_tpu_torch.solvers.config import config_from_jax
from fluidsolver_tpu_torch.vof import plic
from fluidsolver_tpu_torch.vof.curvature import curvature_quad_volume_matching
from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator
from tests.golden_cases import two_phase_drop

torch.set_num_threads(1)
TOL = 1e-12


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, rtol=0.0, atol=0.0, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def port_op(jop):
    return StencilOp(**{f.name: T(getattr(jop, f.name)) for f in dataclasses.fields(jop)})


def cg_setup(nx, ny, seed):
    """A 1 / 1000 random-jump operator of an nx x ny box and four seeded
    vectors of its shape (tests/test_padded_carry.py's inputs)."""
    rng = np.random.default_rng(seed)
    g = jmake_grid(0.0, 1.0, nx, 0.0, 1.3, ny)
    rho_u = jnp.asarray(np.where(rng.random(g.shape_u) > 0.5, 1000.0, 1.0))
    rho_v = jnp.asarray(np.where(rng.random(g.shape_v) > 0.5, 1000.0, 1.0))
    op = jlin.assemble_pressure_operator(rho_u, rho_v, g.dx, g.dy, None)
    return (op, *(rng.normal(size=op.aC.shape) for _ in range(4)))


# ---- kernels 5-7: step_ab, step_c, step_init ----------------------------------
@pytest.mark.parametrize("shape", [(62, 62), (94, 40), (63, 41)])
def test_step_ab_twin_matches_pallas(shape):
    jop, x, r, p, _ = cg_setup(*shape, seed=5)
    want = pc.step_ab(jop, jnp.asarray(x), jnp.asarray(r), jnp.asarray(p), jnp.asarray(1.37),
                      interpret=True)
    got = cuda_cg.step_ab(port_op(jop), T(x), T(r), T(p), torch.tensor(1.37, dtype=torch.float64))
    assert all(s.shape == () for s in got[2:])
    close(got[0], want[0], 1e-12, 1e-12, "x'")
    close(got[1], want[1], 1e-10, 1e-9, "r'")
    close(float(got[2]), float(want[2]), 1e-12, 0.0, "pAp")
    close(float(got[3]), float(want[3]), 1e-10, 0.0, "rr")
    close(float(got[4]), float(want[4]), 1e-9, 1e-9, "sum_r")


@pytest.mark.parametrize("with_p", [True, False])
@pytest.mark.parametrize("singular", [False, True])
def test_step_c_twin_matches_pallas(singular, with_p):
    """Both forms: the iteration (p given) and the solve-init form (p=None,
    p' = z, the same tensor)."""
    _, _, r, p, z_raw = cg_setup(62, 62, seed=9)
    sum_r = np.sum(r)
    want = pc.step_c(jnp.asarray(r), jnp.asarray(z_raw), jnp.asarray(p) if with_p else None,
                     jnp.asarray(0.73), singular, sum_r=jnp.asarray(sum_r), interpret=True)
    got = cuda_cg.step_c(T(r), T(z_raw), T(p) if with_p else None,
                         torch.tensor(0.73, dtype=torch.float64), singular,
                         sum_r=torch.tensor(sum_r))
    close(got[0], want[0], 1e-12, 1e-13, "z")
    close(got[1], want[1], 1e-9, 1e-10, "p'")
    close(float(got[2]), float(want[2]), 1e-10, 1e-12, "rz_new")
    assert (got[1] is got[0]) == (not with_p)


def test_step_c_singular_needs_sum_r():
    r = torch.ones(4, 4, dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_cg.step_c(r, r, None, torch.ones((), dtype=torch.float64), True)


@pytest.mark.parametrize("kernel", ["step_ab", "step_c"])
def test_division_guard_matches_pallas(kernel):
    """A zero divisor divides by 1: pAp = 0 (p = 0) in step_ab gives
    alpha = rz; rz_prev = 0 in step_c gives beta = rz_new."""
    jop, x, r, p, z_raw = cg_setup(62, 62, seed=11)
    if kernel == "step_ab":
        p = np.zeros_like(p)
        want = pc.step_ab(jop, jnp.asarray(x), jnp.asarray(r), jnp.asarray(p), jnp.asarray(1.37),
                          interpret=True)
        got = cuda_cg.step_ab(port_op(jop), T(x), T(r), T(p), torch.tensor(1.37, dtype=torch.float64))
        assert float(got[2]) == 0.0 and torch.equal(got[0], T(x)) and torch.equal(got[1], T(r))
        tols = ((1e-12, 1e-12), (1e-10, 1e-9), (0.0, 0.0), (1e-10, 0.0), (1e-9, 1e-9))
    else:
        want = pc.step_c(jnp.asarray(r), jnp.asarray(z_raw), jnp.asarray(p), jnp.asarray(0.0), False,
                         interpret=True)
        got = cuda_cg.step_c(T(r), T(z_raw), T(p), torch.tensor(0.0, dtype=torch.float64), False)
        close(got[1], got[0] + got[2] * T(p), 1e-15, 1e-15, "p' = z + rz_new p")
        tols = ((1e-12, 1e-13), (1e-9, 1e-10), (1e-10, 1e-12))
    for k, (g, w, (rtol, atol)) in enumerate(zip(got, want, tols)):
        close(g, w, rtol, atol, f"output {k}")


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("singular", [False, True])
def test_step_init_twin_matches_pallas(singular, warm):
    """The Pallas kernel runs in its band layout (pad_operator, pad_vec,
    extract_vec on the JAX side only); the port has no such layout."""
    jop, b, x0, _, _ = cg_setup(62, 44, seed=17)
    if singular:
        b = b - np.mean(b)
    shape = b.shape
    xp, rp, *scal = pc.step_init(pc.pad_operator(jop, shape), pc.pad_vec(jnp.asarray(b), shape),
                                 pc.pad_vec(jnp.asarray(x0), shape) if warm else None,
                                 singular=singular, shape=shape, interpret=True)
    got = cuda_cg.step_init(port_op(jop), T(b), T(x0) if warm else None, singular)
    close(got[0], pc.extract_vec(xp, shape), 1e-13, 1e-13, "x0'")
    close(got[1], pc.extract_vec(rp, shape), 1e-13, 1e-12, "r0'")
    close(float(got[2]), float(scal[0]), 1e-12, 0.0, "bb")
    close(float(got[3]), float(scal[1]), 1e-11, 1e-13, "rr0")
    close(float(got[4]), float(scal[2]), 1e-10, 1e-11, "sum_r0")


def test_step_init_guard_rejects_a_bad_guess():
    """A warm start worse than zero is dropped: (x0', r0') = (0, b1) and
    rr0 = bb, as with a cold start."""
    jop, b, _, _, _ = cg_setup(62, 44, seed=17)
    op = port_op(jop)
    bad = 1e6 * T(b)
    x, r, bb, rr0, sum_r0 = cuda_cg.step_init(op, T(b), bad, False)
    cold = cuda_cg.step_init(op, T(b), None, False)
    assert float(x.abs().max()) == 0.0 and torch.equal(r, cold[1])
    assert float(rr0) == float(bb) == float(cold[2]) and float(sum_r0) == float(cold[4])


# ---- kernel 8: fused_momentum -------------------------------------------------
@pytest.mark.parametrize("nx,ny,gravity", [(62, 47, (0.3, -9.81)), (33, 94, (0.3, -9.81)),
                                           (62, 47, (0.0, 0.0))])
def test_fused_momentum_twin_matches_pallas(nx, ny, gravity):
    rng = np.random.default_rng(7)
    g = jmake_grid(0.0, 1.0, nx, 0.0, 1.3, ny)
    u, v, c = g.shape_u, g.shape_v, g.shape_center
    args = [rng.normal(size=u), rng.normal(size=v), rng.normal(size=u), rng.normal(size=v),
            rng.uniform(1.0, 1000.0, u), rng.uniform(1.0, 1000.0, v),
            rng.uniform(1.0, 1000.0, u), rng.uniform(1.0, 1000.0, v),
            rng.uniform(1e-3, 1e-1, c), rng.normal(size=c), rng.normal(size=u), rng.normal(size=v)]
    dt, rho_eps = 1e-3, 1e-3
    gx, gy = gravity
    kw = dict(dx=g.dx, dy=g.dy, rho_eps=rho_eps, gx=gx, gy=gy)
    want = jfused_momentum(*(jnp.asarray(a) for a in args), dt, interpret=True, **kw)
    got = cuda_momentum.fused_momentum(*(T(a) for a in args), torch.tensor(dt, dtype=torch.float64),
                                       **kw)
    for k, (gt, w, atol) in enumerate(zip(got, want, (1e-11, 1e-11, 1e-12, 1e-12))):
        assert gt.shape == w.shape
        close(gt, w, 0.0, atol, ("rho_u", "rho_v", "U", "V")[k])
    # outside the interior faces the base values stay, the last U row included
    assert torch.equal(got[2][-1], T(args[0])[-1]) and torch.equal(got[0][0], T(args[6])[0])


# ---- kernel 13: fused_rhs --------------------------------------------------------
def rhs_inputs(nx, ny, dtype):
    """The fused RHS's inputs on an nx x ny box: a drop's vf with its
    ELVIRA curvature and interface lengths, seeded velocities, face
    densities between the two phases' and old jumps."""
    g = make_grid(0.0, 1.0, nx, 0.0, 1.3, ny)
    vf = liquid_fraction_from_indicator(lambda x, y: (x - 0.45) ** 2 + (y - 0.6) ** 2 < 0.3 ** 2, g, n=4)
    vf = torch.as_tensor(vf, dtype=dtype)
    rec = plic.elvira(vf, g.dx, g.dy)
    curv = curvature_quad_volume_matching(vf, rec, g)
    length = plic.interface_length(rec, g.dx, g.dy)
    assert int(rec.valid.sum()) > 8 and float(curv.abs().max()) > 0.0
    rng = np.random.default_rng(nx * ny)
    u, v = g.shape_u, g.shape_v
    U, V, pj_u_old, pj_v_old = (torch.as_tensor(rng.normal(size=s), dtype=dtype) for s in (u, v, u, v))
    rho_u, rho_v = (torch.as_tensor(rng.uniform(1.0, 1000.0, s), dtype=dtype) for s in (u, v))
    return g, (U, V, vf, curv, length, rho_u, rho_v, pj_u_old, pj_v_old,
               torch.tensor(1.7e-3, dtype=dtype))


RHS_BOXES = [(18, 10), (34, 66)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("nx,ny", RHS_BOXES)
def test_fused_rhs_twin_is_the_unfused_sequence(nx, ny, dtype):
    """The twin is the subiteration's RHS stage as it was written inline
    (divergence, jump, increment added on the interior), bitwise; the
    jumps' ghost rings are zero."""
    g, args = rhs_inputs(nx, ny, dtype)
    U, V, vf, curv, length, rho_u, rho_v, pj_u_old, pj_v_old, dt = args
    sigma = 1.0 / 200
    div = stencil.divergence(U, V, g.dx, g.dy)
    pj_u, pj_v = mom.calc_pressure_jump(vf, curv, length, sigma, g.dx, g.dy)
    dpj_u = pj_u - pj_u_old
    dpj_v = pj_v - pj_v_old
    div = fields.add_interior(div, dt * (
        (dpj_u[2:-1, 1:-1] / rho_u[2:-1, 1:-1] - dpj_u[1:-2, 1:-1] / rho_u[1:-2, 1:-1]) / g.dx
        + (dpj_v[1:-1, 2:-1] / rho_v[1:-1, 2:-1] - dpj_v[1:-1, 1:-2] / rho_v[1:-1, 1:-2]) / g.dy
    ))
    got = cuda_rhs.fused_rhs(*args, sigma=sigma, dx=g.dx, dy=g.dy)
    for k, (a, b) in enumerate(zip(got, (div, pj_u, pj_v))):
        assert a.dtype == dtype and a.shape == b.shape and torch.equal(a, b), k
    for pj in got[1:]:
        ring = torch.ones_like(pj, dtype=torch.bool)
        ring[1:-1, 1:-1] = False
        assert float(pj[ring].abs().max()) == 0.0 and float(pj.abs().max()) > 0.0


@pytest.mark.parametrize("nx,ny", RHS_BOXES)
def test_fused_rhs_twin_matches_jax(nx, ny):
    """The twin against the JAX package's pressure_jump RHS
    (solvers/twophase.py: divergence, calc_pressure_jump, the increment
    over the face densities) in f64, to 1e-14 of each output's largest
    magnitude."""
    g, args = rhs_inputs(nx, ny, torch.float64)
    sigma = 1.0 / 200
    got = cuda_rhs.fused_rhs(*args, sigma=sigma, dx=g.dx, dy=g.dy)
    U, V, vf, curv, length, rho_u, rho_v, pj_u_old, pj_v_old, dt = (jnp.asarray(a.numpy()) for a in args)
    pj_u, pj_v = jmom.calc_pressure_jump(vf, curv, length, sigma, g.dx, g.dy, pj_u_old, pj_v_old)
    dpj_u = pj_u - pj_u_old
    dpj_v = pj_v - pj_v_old
    div = jadd_interior(jstencil.divergence(U, V, g.dx, g.dy), dt * (
        (dpj_u[2:-1, 1:-1] / rho_u[2:-1, 1:-1] - dpj_u[1:-2, 1:-1] / rho_u[1:-2, 1:-1]) / g.dx
        + (dpj_v[1:-1, 2:-1] / rho_v[1:-1, 2:-1] - dpj_v[1:-1, 1:-2] / rho_v[1:-1, 1:-2]) / g.dy
    ))
    for name, a, b in zip(("div", "p_jump_u", "p_jump_v"), got, (div, pj_u, pj_v)):
        assert a.shape == b.shape and max_rel(a, b) <= 1e-14, (name, max_rel(a, b))


def test_fused_rhs_wrapper_rejects_what_the_kernel_does_not_take(monkeypatch):
    """fused_rhs_cuda raises on a field of the wrong shape before any
    launch, and on bf16, for which the entry point returns
    cudaErrorInvalidValue (1), without counting a launch."""
    g, args = rhs_inputs(18, 10, torch.float32)
    bad = list(args)
    bad[1] = bad[1][:, :-1].contiguous()
    with pytest.raises(ValueError, match="fused_rhs takes"):
        cuda_rhs.fused_rhs_cuda(*bad, sigma=0.005, dx=g.dx, dy=g.dy)
    codes = []

    class Lib:
        def fs_fused_rhs(self, dtype, *rest):
            codes.append(dtype)
            return 0 if dtype in (0, 1) else 1

    monkeypatch.setattr(_kernels, "lib", Lib)
    monkeypatch.setattr(_kernels, "stream", lambda device: None)
    monkeypatch.setattr(_kernels, "launches", collections.Counter())
    bf16 = [a.to(torch.bfloat16) for a in args]
    with pytest.raises(RuntimeError, match="fused_rhs launch failed: cudaError 1"):
        cuda_rhs.fused_rhs_cuda(*bf16, sigma=0.005, dx=g.dx, dy=g.dy)
    cuda_rhs.fused_rhs_cuda(*args, sigma=0.005, dx=g.dx, dy=g.dy)
    assert codes == [2, 0] and dict(_kernels.launches) == {"fused_rhs": 1}


# ---- the fused PCG solve --------------------------------------------------------
def drop_operator(n, pin):
    g = jmake_grid(0.0, 1.0, n, 0.0, 1.0, n)

    def rho(shape):
        X, Y = np.meshgrid(np.linspace(0, 1, shape[0]), np.linspace(0, 1, shape[1]), indexing="ij")
        return jnp.asarray(np.where((X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.09, 1000.0, 1.0))

    return jlin.assemble_pressure_operator(rho(g.shape_u), rho(g.shape_v), g.dx, g.dy, pin)


@pytest.mark.parametrize("singular,warm", [(True, False), (False, True)])
def test_solve_pcg_fused_matches_jax(singular, warm):
    """solve_pcg (step_init, step_ab, step_c) on a 64^2 1000:1 disc at tol
    1e-8 against the JAX package's plain solve: no more than 3 extra
    iterations, x within 1e-5 max|x| (test_pallas_cg.py)."""
    jop = drop_operator(64, None if singular else "left")
    rng = np.random.default_rng(21)
    b = rng.normal(size=jop.aC.shape)
    if singular:
        b = b - b.mean()
    else:
        b[0, :] = 0.0
    x0 = 0.1 * rng.normal(size=b.shape) if warm else None
    kw = dict(tol=1e-8, max_iter=100, singular=singular, precond="boxmg")
    jx, jres, jit = jax.jit(functools.partial(jcg.solve_pcg, **kw))(
        jop, jnp.asarray(b), x0=None if x0 is None else jnp.asarray(x0))
    x, res, it = cg.solve_pcg(port_op(jop), T(b), x0=None if x0 is None else T(x0), **kw)
    assert float(res) < 1e-8 and float(jres) < 1e-8
    assert it <= int(jit) + 3, (it, int(jit))
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-5 * np.abs(jx).max()


@pytest.mark.parametrize("singular", [True, False])
def test_solve_pcg_zero_rhs(singular):
    """b = 0: the solve returns x = 0 after no iteration, with the zero
    warm start's residual 0 (the ||b|| = 0 guard of step_init and the exit
    test)."""
    jop = drop_operator(32, None if singular else "left")
    x, res, it = cg.solve_pcg(port_op(jop), torch.zeros(jop.aC.shape, dtype=torch.float64),
                              tol=1e-8, max_iter=50, singular=singular, precond="boxmg",
                              x0=torch.ones(jop.aC.shape, dtype=torch.float64))
    assert it == 0 and float(res) == 0.0 and float(x.abs().max()) == 0.0


# ---- the slice ------------------------------------------------------------------
def test_golden_two_phase_drop_fused(monkeypatch):
    """The golden drop (64^2, 15 steps, tol 1e-10) against the committed f64
    trajectory (test_torch_twophase.py's bound), through kernels 5-8 with
    the counts of chip_smoke.py's bench phase: per solve one step_init, one
    fused_momentum, one fused_rhs and one init-form step_c, per PCG
    iteration one step_ab and one step_c."""
    calls = count_calls(monkeypatch)
    jrun = two_phase_drop(np.float64)
    case = inspect.getclosurevars(jrun).nonlocals
    jg = case["g"]
    grid = make_grid(jg.x_min, jg.x_max, jg.nx, jg.y_min, jg.y_max, jg.ny)
    state = twophase.two_phase_state_from_numpy(case["state"], "cpu")
    cfg = config_from_jax(case["cfg"])
    iters = []
    out = twophase.run(state, case["t_end"], grid, cfg, callback=lambda s: iters.append(int(s.flow.p_iter)))
    solves = len(iters) * cfg.num_subiter
    assert len(iters) == 15 and dict(calls) == {"step_init": solves, "fused_momentum": solves,
                                                "fused_rhs": solves, "step_ab": sum(iters),
                                                "step_c": sum(iters) + solves}
    gold = dict(np.load("tests/goldens/two_phase_drop.npz"))
    assert float(out.flow.t) == pytest.approx(float(gold["t"]), abs=1e-14)
    got = {"U": out.flow.U, "V": out.flow.V, "p": out.flow.p, "vf": out.vf, "curv": out.curv}
    for k, v in got.items():
        assert max_rel(v, gold[k]) <= TOL, (k, max_rel(v, gold[k]))


@pytest.mark.parametrize("refresh", ["solve", "step"])
def test_two_phase_channel_fused_against_jax(refresh):
    """two_phase_channel(ny=16), 3 steps with cold-started solves (step_init
    without a guess), the port's step against the JAX package's plain step
    (test_torch_twophase.py's case and bound)."""
    kw = dict(pressure_tol=1e-11, pressure_tol_intermediate=1e-9,
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
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state.flow, k), getattr(jstate.flow, k)) <= TOL, k
        for k in ("vf", "curv", "interface_length"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= TOL, k


@pytest.mark.parametrize("name,kwargs", [
    ("incomp_channel", dict(ny=12)),   # callable inflow, outflow correction
    ("taylor_green", dict(n=24)),      # periodic, singular pressure system
])
def test_single_phase_fused_cg_against_jax(monkeypatch, name, kwargs):
    """The single-phase step solves with kernels 5-7 too: 3 steps against
    the JAX package's plain step, pressure tol 1e-11, held to 1e-12
    (test_torch_slice.py's bound)."""
    jcase, tcase = jget_case(name, **kwargs), get_case(name, **kwargs)
    jcase.cfg = dataclasses.replace(jcase.cfg, pressure_tol=1e-11)
    tcase.cfg = dataclasses.replace(tcase.cfg, pressure_tol=1e-11)
    jstate, jstep = jcase.make_state(np.float64), jcase.make_step()
    calls = count_calls(monkeypatch)
    state, step = tcase.make_state(torch.float64, "cpu"), tcase.make_step(torch.float64, "cpu")
    for _ in range(3):
        jstate = jstep(jstate, jcase.t_end)
        state = step(state, tcase.t_end)
        assert float(state.t) == pytest.approx(float(jstate.t), rel=1e-14)
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state, k), getattr(jstate, k)) <= TOL, k
    assert calls["step_init"] == 3 * tcase.cfg.num_subiter and calls["step_ab"] > 0
    assert "fused_momentum" not in calls and "fused_rhs" not in calls


# ---- the kernel calls of a step ------------------------------------------------
def count_calls(monkeypatch) -> collections.Counter:
    """Count the calls of kernels 5-8 and 13's dispatching wrappers, and
    check that the step hands them contiguous tensors (the CUDA wrappers
    raise on others)."""
    calls = collections.Counter()
    for mod, name in ((cuda_cg, "step_ab"), (cuda_cg, "step_c"), (cuda_cg, "step_init"),
                      (cuda_momentum, "fused_momentum"), (cuda_rhs, "fused_rhs")):
        def wrapped(*a, _fn=getattr(mod, name), _name=name, **k):
            calls[_name] += 1
            tensors = [t for v in a for t in (
                [getattr(v, f.name) for f in dataclasses.fields(v)] if isinstance(v, StencilOp)
                else [v]) if isinstance(t, torch.Tensor)]
            assert all(t.is_contiguous() for t in tensors), _name
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapped)
    return calls


@pytest.mark.parametrize("refresh,surface_tension", [("solve", "pressure_jump"),
                                                     ("step", "pressure_jump"),
                                                     ("solve", "tangent_force")])
def test_step_calls_kernels_5_to_8(monkeypatch, refresh, surface_tension):
    """One two-phase step makes the exact calls that chip_smoke.py requires
    per step on the card: step_init and fused_momentum once per
    subiteration, and fused_rhs once per subiteration under
    "pressure_jump" (never under "tangent_force"), step_ab once per PCG
    iteration, step_c once more per solve; every operand contiguous."""
    calls = count_calls(monkeypatch)
    case = get_case("two_phase_channel", ny=8)
    case.cfg = dataclasses.replace(case.cfg, pressure_precond_refresh=refresh,
                                   surface_tension_method=surface_tension)
    state = case.make_state(torch.float64, "cpu")
    state = case.make_step(torch.float64, "cpu")(state, case.t_end)
    n_sub, iters = case.cfg.num_subiter, int(state.flow.p_iter)
    assert iters > 0
    want = {"step_init": n_sub, "fused_momentum": n_sub, "step_ab": iters, "step_c": iters + n_sub}
    if surface_tension == "pressure_jump":
        want["fused_rhs"] = n_sub
    assert dict(calls) == want


def test_step_leaves_no_cyclic_garbage():
    """A two-phase step with the hierarchy rebuilt each solve (BoxMG, f64)
    leaves nothing for the cyclic garbage collector: each solve's
    hierarchy is freed when the solve returns, not when the collector
    next runs (the V-cycle's recursion is no closure that calls itself)."""
    case = get_case("two_phase_channel", ny=8)
    assert case.cfg.pressure_solver == "boxmg" and case.cfg.pressure_precond_refresh == "solve"
    state = case.make_state(torch.float64, "cpu")
    step = case.make_step(torch.float64, "cpu")
    state = step(state, case.t_end)
    gc.collect()
    gc.disable()
    try:
        state = step(state, case.t_end)
        assert int(state.flow.p_iter) > 0
        assert gc.collect() == 0
    finally:
        gc.enable()


# ---- the callable BC's coordinates -------------------------------------------
def test_callable_bc_coordinates_copied_once(monkeypatch):
    """two_phase_channel's callable inflow: the coordinates go to the
    tensor's device once per grid, dtype and device, and the fields are
    those of a run that copies them from the host on every call."""
    case = get_case("two_phase_channel", ny=8)

    def run():
        state = case.make_state(torch.float64, "cpu")
        step = case.make_step(torch.float64, "cpu")
        for _ in range(2):
            state = step(state, case.t_end)
        return state.flow

    bc._coords.cache_clear()
    cached = run()
    info = bc._coords.cache_info()
    assert info.currsize == 1 and info.hits > 0   # the left side's "ym"
    monkeypatch.setattr(bc, "_coords", bc._coords.__wrapped__)
    fresh = run()
    for k in ("U", "V", "p"):
        assert torch.equal(getattr(cached, k), getattr(fresh, k)), k
