"""PCG and the two-phase step with a bf16 V-cycle preconditioner
(``pressure_precond_dtype="bfloat16"``) on the port against the JAX
package on the CPU: ``tests/test_poisson.py``'s protocols (the 64^2 drop
converges; the adversarial checkerboard stays finite) and a few steps of
stationary_drop(16) and two_phase_channel(16) against the JAX step. The
kernels' twins, the cast hierarchy and the dense inverse are held in
``tests/test_torch_bf16.py``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.poisson import cg as jcg
from fluidsolver_tpu.poisson import linsys as jlin
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.poisson import boxmg, cg
from tests.test_torch_bf16 import BF, T, drop_system, to_port

torch.set_num_threads(1)


# ---- PCG with a bf16 preconditioner -----------------------------------------------
@pytest.mark.parametrize("precond", ["boxmg", "mg"])
def test_pcg_bf16_preconditioner_converges(precond):
    """``tests/test_poisson.py``'s protocol on the 64^2 drop (f64 CG, tol
    1e-8): converges, the solution within 1e-4, at most twice the f32
    preconditioner's iterations, and the iterations beside the JAX
    package's (its XLA sweeps round every bf16 operation where the port's
    fused_smooth computes in f32 between its outputs; measured: equal on
    "mg", 9 against 8 on "boxmg")."""
    g, jop = drop_system(64)
    rng = np.random.default_rng(7)
    x_true = rng.normal(size=g.shape_center)
    x_true -= x_true.mean()
    jb = jlin.apply_op(jop, jnp.asarray(x_true))
    op, b = to_port(jop), T(jb)
    _, _, it32 = cg.solve_pcg(op, b, tol=1e-8, max_iter=200, singular=True, precond=precond)
    x16, rel, it16 = cg.solve_pcg(op, b, tol=1e-8, max_iter=200, singular=True, precond=precond,
                                  precond_dtype=BF)
    assert x16.dtype == torch.float64
    assert float(rel) < 1e-8
    np.testing.assert_allclose(x16.numpy(), x_true, atol=1e-4)
    assert it16 <= 2 * it32, (it16, it32)
    _, _, jit16 = jcg.solve_pcg(jop, jb, tol=1e-8, max_iter=200, singular=True, precond=precond,
                                precond_dtype=jnp.bfloat16)
    assert abs(it16 - int(jit16)) <= 2, (it16, int(jit16))


@pytest.mark.parametrize("precond", ["boxmg", "mg"])
def test_pcg_bf16_adversarial_stays_finite(precond):
    """``tests/test_poisson.py``'s containment protocol: a 1000:1
    checkerboard, f32 CG, a bf16 preconditioner, 60 iterations at most:
    the iterate and the residual stay finite (the JAX package's run ends
    the same way: BoxMG on its stagnation window at rel 1.0 after 25
    iterations, "mg" at the cap)."""
    rng = np.random.default_rng(3)
    g = jmake_grid(0.0, 1.0, 64, 0.0, 1.0, 64)
    rho_u = torch.as_tensor(np.where(rng.random(g.shape_u) > 0.5, 1000.0, 1.0))
    rho_v = torch.as_tensor(np.where(rng.random(g.shape_v) > 0.5, 1000.0, 1.0))
    from fluidsolver_tpu_torch.poisson import linsys
    op = boxmg.cast_struct(linsys.assemble_pressure_operator(rho_u, rho_v, g.dx, g.dy, None),
                           torch.float32)
    b = torch.as_tensor(rng.normal(size=op.aC.shape), dtype=torch.float32)
    b = b - torch.mean(b)
    levels = cg.build_precond_levels(op, precond, "bfloat16")
    if precond == "boxmg":
        assert levels[-1].coarse_inv.dtype == torch.float32
    x, res, iters = cg.solve_pcg(op, b, tol=1e-5, max_iter=60, singular=True, precond=precond,
                                 levels=levels)
    assert bool(torch.all(torch.isfinite(x))) and bool(torch.isfinite(res))
    assert iters <= 60


# ---- two-phase steps with a bf16 preconditioner -----------------------------------
def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


@pytest.mark.parametrize("name,kw,solver,tol,field_tol,iter_gap", [
    ("stationary_drop", dict(n=16), "boxmg", 1e-10, 1e-8, 1),
    ("two_phase_channel", dict(ny=16), "boxmg", 1e-10, 1e-8, 4),
    ("two_phase_channel", dict(ny=16), "mg", 1e-6, 1e-4, 1),
])
def test_two_phase_steps_bf16_against_jax(name, kw, solver, tol, field_tol, iter_gap):
    """Three steps with ``pressure_precond_dtype="bfloat16"`` (f64 state,
    the hierarchy built once a step) against the JAX step. Measured gaps:
    - BoxMG, tol 1e-10: U, V, p within 2.2e-10 (drop) and 2.5e-11
      (channel) of their largest values, held to 1e-8; p_iter 25, 22, 22
      against JAX's 25, 24, 24 (drop) and 106, 60, 45 against 119, 79, 50
      (channel: the port's f32-compute smoother does better than JAX's
      XLA sweeps, which round every bf16 operation), held to ``iter_gap``
      a solve;
    - "mg" on the 1000:1 channel: neither package's bf16 V-cycle reaches
      the case's tol 1e-6 within its 50 iterations (250, 250, 238 against
      JAX's 250, 250, 241 a step); fields within 1.3e-5, held to 1e-4."""
    cfg_kw = dict(pressure_precond_dtype="bfloat16", pressure_solver=solver, pressure_tol=tol,
                  pressure_tol_intermediate=None, pressure_precond_refresh="step")
    jcase, tcase = jget_case(name, **kw), get_case(name, **kw)
    jcase.cfg = dataclasses.replace(jcase.cfg, **cfg_kw)
    tcase.cfg = dataclasses.replace(tcase.cfg, **cfg_kw)
    jstate, jstep = jcase.make_state(np.float64), jcase.make_step()
    state, step = tcase.make_state(torch.float64, "cpu"), tcase.make_step(torch.float64, "cpu")
    for _ in range(3):
        jstate = jstep(jstate, jcase.t_end)
        s0 = sync.count
        state = step(state, tcase.t_end)
        # dt > 0, one exit test an iteration, one more a solve that ends
        # before its cap
        syncs = sync.count - s0 - 1 - int(state.flow.p_iter)
        assert syncs == tcase.cfg.num_subiter if solver == "boxmg" else 0 <= syncs <= 5
        gap = abs(int(state.flow.p_iter) - int(jstate.flow.p_iter))
        assert gap <= iter_gap * tcase.cfg.num_subiter, (int(state.flow.p_iter), int(jstate.flow.p_iter))
        for k in ("U", "V", "p"):
            assert max_rel(getattr(state.flow, k), getattr(jstate.flow, k)) <= field_tol, k
        assert max_rel(state.vf, jstate.vf) <= field_tol
