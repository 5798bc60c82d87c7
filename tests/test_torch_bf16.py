"""The bf16 V-cycle preconditioner (``pressure_precond_dtype="bfloat16"``)
of the port against the JAX package on the CPU, where the kernel modules
run their plain PyTorch twins.

- ``fused_smooth`` on bf16 storage computes in f32 and rounds its outputs
  once: held to one bf16 ulp (2^-8 relative and absolute) of the Pallas
  kernel in interpret mode (plain and residual forms) and of the f32 XLA
  oracle on the widened operands (restriction and prolongation forms), as
  ``tests/test_pallas_smoother.py`` holds the Pallas kernel.
- ``rb_sweep`` on bf16 computes in bf16: the twin equals the JAX XLA sweep
  ``mg._rb_sweep`` on bf16 bit for bit (measured on both boxes, eager and
  jitted). The Pallas kernel forms A x - aC x without the aC x term and so
  rounds elsewhere: measured up to 1.6e-3 of the field's largest value
  (0.4 ulp of it), held to one ulp of the largest value.
- BoxMG's cast hierarchy: the JAX package's
  ``cast_hierarchy(build_hierarchy(op32), bf16)``, its level shapes, its
  planes within one bf16 ulp and the f32 dense coarse inverse to 1e-4 with
  its constant mode projected out (f32 LU's own gap, see the test).
- ``_dense_coarse_inverse`` in f64 to 1e-12 on a singular and a pinned
  operator.

The solves and the steps with a bf16 preconditioner are in
``tests/test_torch_bf16_solve.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.poisson import boxmg as jbox
from fluidsolver_tpu.poisson import linsys as jlin
from fluidsolver_tpu.poisson import mg as jmg
from fluidsolver_tpu.poisson import pallas_smoother, pallas_vcycle
from fluidsolver_tpu_torch.poisson import _kernels, boxmg, cg, cuda_smoother, cuda_vcycle
from fluidsolver_tpu_torch.poisson.linsys import StencilOp

torch.set_num_threads(1)
BF = torch.bfloat16
ULP = 2.0 ** -8


def T(a):
    return torch.as_tensor(np.array(a))


def T16(a):
    """A JAX bf16 (or wider) array as a torch bf16 tensor (exact for bf16)."""
    return torch.as_tensor(np.asarray(a, np.float32)).to(BF)


def to_port(obj, conv=T):
    cls = {"StencilOp": StencilOp, "Stencil9": boxmg.Stencil9, "BoxTransfer": boxmg.BoxTransfer}
    return cls[type(obj).__name__](**{f.name: conv(getattr(obj, f.name))
                                      for f in dataclasses.fields(obj)})


def jcast(obj, dtype):
    return dataclasses.replace(obj, **{f.name: getattr(obj, f.name).astype(dtype)
                                       for f in dataclasses.fields(obj)})


def within_ulp(got, want, rtol=ULP, atol=ULP, what=""):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=rtol, atol=atol, err_msg=what)


def jump_level(nx, ny, seed):
    """``tests/test_pallas_smoother.py``'s level: a 1000:1 random jump
    operator, its transfer weights, b and x0 (f64)."""
    rng = np.random.default_rng(seed)
    g = jmake_grid(0.0, 1.0, nx, 0.0, 1.3, ny)
    rho_u = jnp.asarray(np.where(rng.random(g.shape_u) > 0.5, 1000.0, 1.0))
    rho_v = jnp.asarray(np.where(rng.random(g.shape_v) > 0.5, 1000.0, 1.0))
    op = jlin.assemble_pressure_operator(rho_u, rho_v, g.dx, g.dy, None)
    b = jnp.asarray(rng.normal(size=g.shape_center))
    x0 = jnp.asarray(rng.normal(size=g.shape_center))
    return op, jbox.collapse_weights(op), b, x0


def drop_system(n, pin=None, ratio=1000.0):
    """``tests/test_poisson.py``'s drop: a liquid disc in gas."""
    g = jmake_grid(0.0, 1.0, n, 0.0, 1.0, n)
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    Xv, Yv = np.meshgrid(g.xm, g.y, indexing="ij")
    rho_u = np.where((Xu - 0.5) ** 2 + (Yu - 0.5) ** 2 < 0.25 ** 2, ratio, 1.0)
    rho_v = np.where((Xv - 0.5) ** 2 + (Yv - 0.5) ** 2 < 0.25 ** 2, ratio, 1.0)
    return g, jlin.assemble_pressure_operator(jnp.asarray(rho_u), jnp.asarray(rho_v), g.dx, g.dy, pin)


# ---- kernel #1: fused_smooth on bf16 storage --------------------------------------
@pytest.fixture(scope="module")
def level62():
    op, tr, b, x0 = jump_level(62, 62, seed=37)
    op16, tr16 = jcast(op, jnp.bfloat16), jcast(tr, jnp.bfloat16)
    return dict(op16=op16, tr16=tr16, op32=jcast(op16, jnp.float32), tr32=jcast(tr16, jnp.float32),
                b16=b.astype(jnp.bfloat16), x016=x0.astype(jnp.bfloat16),
                pop=to_port(op16, T16), ptr=to_port(tr16, T16))


@pytest.mark.parametrize("residual", [False, True])
def test_fused_smooth_bf16_matches_pallas(level62, residual):
    """Plain and residual forms against the Pallas kernel (interpret mode)
    on bf16 operands: outputs bf16, within one bf16 ulp."""
    L = level62
    colors = (True, False, True, False)
    want = pallas_vcycle.fused_smooth(L["op16"], L["b16"], x0=L["x016"], colors=colors,
                                      residual=residual, interpret=True)
    got = cuda_vcycle.fused_smooth(L["pop"], T16(L["b16"]), x0=T16(L["x016"]), colors=colors,
                                   residual=residual)
    want, got = (want, got) if residual else ((want,), (got,))
    for g, w, what in zip(got, want, ("x", "r")):
        assert g.dtype == BF
        within_ulp(g, w, what=what)


def test_fused_smooth_bf16_transfer_forms_match_f32_oracle(level62):
    """Restriction and prolongation forms against the JAX package's f32 XLA
    sweeps, ``restrict_box`` and ``prolong_box`` on the widened operands,
    cast down (the restricted residual to 2^-7 absolute, as the JAX
    package's own test holds it)."""
    L = level62
    b32, x032 = L["b16"].astype(jnp.float32), L["x016"].astype(jnp.float32)
    lvl32 = jbox.BoxLevel(op=L["op32"], red=jbox._checkerboard(b32.shape, jnp.float32), tr=None)
    x_ref = jbox._rb_sweep(lvl32, jnp.zeros_like(b32), b32)
    bc_ref = jbox.restrict_box(L["tr32"], b32 - jlin.apply_op(L["op32"], x_ref))
    x, bc = cuda_vcycle.fused_smooth(L["pop"], T16(L["b16"]), colors=(True, False), tr=L["ptr"],
                                     restrict=True)
    within_ulp(x, x_ref.astype(jnp.bfloat16), what="x")
    within_ulp(bc, bc_ref.astype(jnp.bfloat16), atol=2 * ULP, what="coarse r")

    ec16 = jnp.asarray(np.random.default_rng(41).normal(size=L["tr32"].pW.shape)).astype(jnp.bfloat16)
    x_ref = x032 + jbox.prolong_box(L["tr32"], ec16.astype(jnp.float32), b32.shape)
    x_ref = jbox._rb_sweep(lvl32, x_ref, b32, reverse=True)
    x = cuda_vcycle.fused_smooth(L["pop"], T16(L["b16"]), x0=T16(L["x016"]), colors=(False, True),
                                 tr=L["ptr"], ec=T16(ec16))
    within_ulp(x, x_ref.astype(jnp.bfloat16), what="x after ec")


def test_fused_smooth_bf16_nine_point():
    """A 9-point (Galerkin) level, residual form, against the f32 XLA oracle
    on the widened operands."""
    op, tr, b, x0 = jump_level(30, 22, seed=11)
    op9 = jcast(jbox.galerkin_closed(op, tr, op.aC.shape), jnp.bfloat16)
    op9_32 = jcast(op9, jnp.float32)
    rng = np.random.default_rng(3)
    b16 = jnp.asarray(rng.normal(size=op9.aC.shape)).astype(jnp.bfloat16)
    x016 = jnp.asarray(rng.normal(size=op9.aC.shape)).astype(jnp.bfloat16)
    lvl32 = jbox.BoxLevel(op=op9_32, red=jbox._checkerboard(b16.shape, jnp.float32), tr=None)
    x_ref = jbox._rb_sweep(lvl32, x016.astype(jnp.float32), b16.astype(jnp.float32))
    r_ref = b16.astype(jnp.float32) - jbox.apply_any(op9_32, x_ref)
    x, r = cuda_vcycle.fused_smooth(to_port(op9, T16), T16(b16), x0=T16(x016),
                                    colors=(True, False), residual=True)
    within_ulp(x, x_ref.astype(jnp.bfloat16), what="x")
    within_ulp(r, r_ref.astype(jnp.bfloat16), what="r")


# ---- kernel #9: rb_sweep on bf16 --------------------------------------------------
@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("grid", [(30, 22), (31, 19)])
def test_rb_sweep_bf16_matches_jax(grid, reverse):
    """The bf16 sweep (every operation rounded to bf16) equals the JAX XLA
    sweep on bf16 bit for bit, and stays within one bf16 ulp of the
    field's largest value of the Pallas kernel (interpret mode)."""
    op, _, b, x0 = jump_level(*grid, seed=5)
    op16, b16, x16 = jcast(op, jnp.bfloat16), b.astype(jnp.bfloat16), x0.astype(jnp.bfloat16)
    got = cuda_smoother.rb_sweep(to_port(op16, T16), T16(x16), T16(b16), reverse)
    assert got.dtype == BF
    red = jmg._checkerboard(op16.aC.shape, jnp.bfloat16)
    xla = jmg._rb_sweep(jmg.MGLevel(op=op16, red=red), x16, b16, reverse)
    assert torch.equal(got, T16(xla))
    pal = pallas_smoother.rb_sweep_pallas(op16, x16, b16, reverse, interpret=True)
    scale = float(jnp.abs(pal.astype(jnp.float32)).max())
    within_ulp(got, pal, rtol=0.0, atol=ULP * scale)


# ---- BoxMG's cast hierarchy and the dense coarse inverse --------------------------
@pytest.mark.parametrize("shape", [(62, 62), (45, 30)])
def test_cast_hierarchy_matches_jax(shape):
    """The port's cast hierarchy against the JAX package's, from the f32
    operator: level shapes, planes within one bf16 ulp of each plane's
    largest value, and the f32 dense inverse. The f32 inverse of these
    nearly singular jump operators is as exact as f32 LU allows: the two
    packages' inversions of the same f32 matrix (JAX's coarsest operator)
    differ by up to 5.2e-4 of the largest entry, most of it in the
    constant mode, which the deflation shift sets and the singular PCG
    projects out. So the inverse is held with the constant mode projected
    out (measured 3.0e-5; held to 1e-4), and to 1e-10 from the f64
    operator, whose inverse is built in f64."""
    op, _, _, _ = jump_level(*shape, seed=13)
    for dtype, inv_tol in ((jnp.float32, 1e-4), (jnp.float64, 1e-10)):
        opd = jcast(op, dtype)
        want = jax.jit(lambda o: jbox.cast_hierarchy(jbox.build_hierarchy(o), jnp.bfloat16))(opd)
        got = cg.build_precond_levels(to_port(opd), "boxmg", "bfloat16")
        assert [tuple(lv.op.aC.shape) for lv in got] == [tuple(lv.op.aC.shape) for lv in want]
        assert all(lv.tail is None for lv in got)
        for k, (g, w) in enumerate(zip(got, want)):
            for part in ("op", "tr"):
                if getattr(w, part) is None:
                    assert getattr(g, part) is None
                    continue
                for f in dataclasses.fields(getattr(w, part)):
                    gp, wp = getattr(getattr(g, part), f.name), getattr(getattr(w, part), f.name)
                    assert gp.dtype == BF
                    within_ulp(gp, wp, atol=ULP * float(jnp.abs(wp.astype(jnp.float32)).max()),
                               what=f"level {k} {part}.{f.name}")
        ginv, winv = got[-1].coarse_inv, np.asarray(want[-1].coarse_inv, np.float64)
        assert ginv.dtype == (torch.float32 if dtype == jnp.float32 else torch.float64)
        n = winv.shape[0]
        P = np.eye(n) - 1.0 / n
        want_p = P @ winv @ P
        diff = P @ (ginv.numpy().astype(np.float64) - winv) @ P
        assert np.abs(diff).max() <= inv_tol * np.abs(want_p).max(), np.abs(diff).max()


@pytest.mark.parametrize("pin", [None, "left"])
def test_dense_coarse_inverse_matches_jax(pin):
    """The coarsest (9-point) level of the 34^2 drop, singular (deflated)
    and pinned (inverted as it is), and a 5-point operator, in f64."""
    _, op = drop_system(32, pin=pin)
    coarsest = jbox.build_hierarchy(op)[-1].op
    for jop in (coarsest, jlin.StencilOp(*(getattr(op, n)[:12, :10] for n in ("aC", "aL", "aR", "aB", "aT")))):
        want = np.asarray(jbox._dense_coarse_inverse(jop))
        got = boxmg._dense_coarse_inverse(to_port(jop))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), want, rtol=0.0, atol=1e-12 * np.abs(want).max())


def test_precond_dtype_names():
    assert _kernels.torch_dtype("bfloat16") == BF and _kernels.torch_dtype(BF) == BF
    assert _kernels.torch_dtype("float32") == torch.float32
    assert _kernels.dtype_code(BF) == 2
    for bad in ("bf8", "int8", "bool"):
        with pytest.raises(ValueError):
            _kernels.torch_dtype(bad)
