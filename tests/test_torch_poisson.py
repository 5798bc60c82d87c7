"""The port's BoxMG algebra and the plain PyTorch twins of its four CUDA
kernels against the JAX package: the XLA functions, and the Pallas kernels
in interpret mode, on the same seeded numpy inputs in f64.

Tolerances are those the JAX package holds its Pallas kernels to
(tests/test_pallas_rap.py, test_pallas_smoother.py, test_pallas_tail.py):
fused_rap rtol 1e-13 / atol 1e-11, fused_smooth atol 1e-12 (restriction
rtol 1e-11), tail_cycle rtol 1e-12, the tail setup rtol 1e-10 through one
cycle (the Pallas setup forms the Galerkin product by comb probing, the
port in closed form: equal to rounding, compounding per level).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.poisson import boxmg as jbox
from fluidsolver_tpu.poisson import cg as jcg
from fluidsolver_tpu.poisson import linsys as jlin
from fluidsolver_tpu.poisson import pallas_rap, pallas_tail, pallas_vcycle
from fluidsolver_tpu_torch.poisson import _kernels, boxmg, cg, cuda_rap, cuda_tail, cuda_vcycle
from fluidsolver_tpu_torch.poisson.linsys import StencilOp

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def to_port(obj):
    """A JAX-package Stencil/BoxTransfer dataclass as the port's."""
    cls = {"StencilOp": StencilOp, "Stencil9": boxmg.Stencil9, "BoxTransfer": boxmg.BoxTransfer}
    return cls[type(obj).__name__](**{f.name: T(getattr(obj, f.name)) for f in dataclasses.fields(obj)})


def to_jax(obj):
    """A port Stencil/BoxTransfer dataclass as the JAX package's."""
    cls = {"StencilOp": jlin.StencilOp, "Stencil9": jbox.Stencil9, "BoxTransfer": jbox.BoxTransfer}
    return cls[type(obj).__name__](**{f.name: jnp.asarray(getattr(obj, f.name).numpy())
                                      for f in dataclasses.fields(obj)})


def assert_close(got, want, rtol=0.0, atol=0.0, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def jump_operator(nx, ny, seed=13):
    """JAX pressure operator of an nx x ny box with 1 / 1000 face densities."""
    rng = np.random.default_rng(seed)
    g = jmake_grid(0.0, 1.0, nx, 0.0, 1.3, ny)
    rho_u = jnp.asarray(np.where(rng.random(g.shape_u) > 0.5, 1000.0, 1.0))
    rho_v = jnp.asarray(np.where(rng.random(g.shape_v) > 0.5, 1000.0, 1.0))
    return jlin.assemble_pressure_operator(rho_u, rho_v, g.dx, g.dy, None)


def drop_operator(nx, ny, pin=None):
    """JAX pressure operator of a 1000:1 drop: the structured jump BoxMG
    converges on in ~10 iterations."""
    g = jmake_grid(0.0, 1.0, nx, 0.0, 1.0, ny)

    def rho(shape):
        X, Y = np.meshgrid(np.linspace(0, 1, shape[0]), np.linspace(0, 1, shape[1]), indexing="ij")
        return jnp.asarray(np.where((X - 0.5) ** 2 + (Y - 0.5) ** 2 < 0.09, 1000.0, 1.0))

    return jlin.assemble_pressure_operator(rho(g.shape_u), rho(g.shape_v), g.dx, g.dy, pin)


# the JAX package's transfer weights under jit (one compile a shape)
_collapse = jax.jit(jbox.collapse_weights)


@functools.lru_cache(maxsize=None)
def _jax_build(deep):
    return jax.jit(jbox.build_hierarchy)


def jax_levels(op, deep=False):
    """The JAX package's stock XLA hierarchy, built under jit as its solver
    builds it (``deep``: the direct stop disabled, more and smaller levels
    and no dense inverse)."""
    cap = jbox.DIRECT_CAP
    if deep:
        jbox.DIRECT_CAP = 0
    try:
        return _jax_build(deep)(op)
    finally:
        jbox.DIRECT_CAP = cap


@pytest.mark.parametrize("shape", [(63, 41)])
def test_boxmg_algebra_matches(shape):
    jop = jump_operator(*shape)
    op = to_port(jop)
    jtr = _collapse(jop)
    tr = boxmg.collapse_weights(op)
    for f in dataclasses.fields(jtr):
        assert_close(getattr(tr, f.name), getattr(jtr, f.name), 1e-13, 1e-13, f.name)
    jc = jax.jit(jbox.galerkin_closed, static_argnums=2)(jop, jtr, tuple(jop.aC.shape))
    c = boxmg.galerkin_closed(op, tr, tuple(op.aC.shape))
    for f in dataclasses.fields(jc):
        assert_close(getattr(c, f.name), getattr(jc, f.name), 1e-13, 1e-11, f.name)
    rng = np.random.default_rng(3)
    r, x = rng.normal(size=jop.aC.shape), rng.normal(size=jop.aC.shape)
    e = rng.normal(size=jtr.pW.shape)
    assert_close(boxmg.restrict_box(tr, T(r)), jbox.restrict_box(jtr, jnp.asarray(r)), 0, 1e-12)
    assert_close(boxmg.prolong_box(tr, T(e), r.shape), jbox.prolong_box(jtr, jnp.asarray(e), r.shape), 0, 1e-12)
    assert_close(boxmg.apply_op9(c, T(e)), jbox.apply_op9(jc, jnp.asarray(e)), 1e-13, 1e-11)
    level = jbox.BoxLevel(op=jop, red=jbox._checkerboard(r.shape, r.dtype), tr=jtr)
    for reverse in (False, True):
        assert_close(boxmg._rb_sweep(op, T(x), T(r), reverse),
                     jbox._rb_sweep(level, jnp.asarray(x), jnp.asarray(r), reverse), 0, 1e-12)


@pytest.mark.parametrize("shape,nine", [((65, 63), False), ((33, 32), True), ((17, 11), True)])
def test_fused_rap_twin_matches_pallas(shape, nine):
    """(17, 11): a 9-point level whose coarse grid (9 x 6) is smaller than
    one tile of the CUDA kernel, with odd sides."""
    jop = jump_operator(shape[0] - 2, shape[1] - 2, seed=shape[0])
    if nine:  # the Galerkin coarse operator of a finer jump operator
        fine = to_port(jump_operator(2 * shape[0] - 3, 2 * shape[1] - 3, seed=shape[1]))
        jop = to_jax(cuda_rap.fused_rap_twin(fine)[1])
        assert tuple(jop.aC.shape) == shape
    jtr, jc, _ = pallas_rap.fused_rap(jop, interpret=True)
    tr, c = cuda_rap.fused_rap(to_port(jop))
    for f in dataclasses.fields(jtr):
        assert_close(getattr(tr, f.name), getattr(jtr, f.name), 1e-13, 1e-11, f.name)
    for f in dataclasses.fields(jc):
        assert_close(getattr(c, f.name), getattr(jc, f.name), 1e-13, 1e-11, f.name)


_SMOOTH_VARIANTS = ("plain", "residual", "restrict", "ec")


def smooth_operator(shape):
    """The operators fused_smooth meets: (63, 41) is the 5-point jump
    operator of a 63 x 41-cell box (the finest level), (32, 21) the 9-point
    Galerkin coarse operator of that box's 5-point operator (a coarse level,
    as at 513^2 and 257^2 in the bench hierarchy)."""
    if shape == (63, 41):
        return jump_operator(*shape)
    fine = to_port(jump_operator(2 * shape[0] - 1, 2 * shape[1] - 1))
    return to_jax(cuda_rap.fused_rap_twin(fine)[1])


@pytest.mark.parametrize("shape", [(63, 41), (32, 21)])
def test_fused_smooth_twin_matches_pallas(shape):
    jop = smooth_operator(shape)
    jtr = _collapse(jop)
    planes = pallas_vcycle.pack_transfer(jtr, jop.aC.shape)
    op, tr = to_port(jop), to_port(jtr)
    rng = np.random.default_rng(17)
    b, x0 = rng.normal(size=jop.aC.shape), rng.normal(size=jop.aC.shape)
    ec = rng.normal(size=jtr.pW.shape)
    for variant in _SMOOTH_VARIANTS:
        if variant == "plain":
            kw = dict(colors=(False, True, False, True))
            got = cuda_vcycle.fused_smooth(op, T(b), x0=T(x0), **kw)
            want = pallas_vcycle.fused_smooth(jop, jnp.asarray(b), x0=jnp.asarray(x0), interpret=True, **kw)
            got, want = (got,), (want,)
        elif variant == "residual":
            kw = dict(colors=(True, False, True, False), residual=True)
            got = cuda_vcycle.fused_smooth(op, T(b), **kw)
            want = pallas_vcycle.fused_smooth(jop, jnp.asarray(b), interpret=True, **kw)
        elif variant == "restrict":
            kw = dict(colors=(True, False, True, False), restrict=True)
            got = cuda_vcycle.fused_smooth(op, T(b), tr=tr, **kw)
            want = pallas_vcycle.fused_smooth(jop, jnp.asarray(b), tr_planes=planes, interpret=True, **kw)
        else:
            kw = dict(colors=(False, True, False, True))
            got = cuda_vcycle.fused_smooth(op, T(b), x0=T(x0), tr=tr, ec=T(ec), **kw)
            want = pallas_vcycle.fused_smooth(jop, jnp.asarray(b), x0=jnp.asarray(x0), tr_planes=planes,
                                              ec=jnp.asarray(ec), interpret=True, **kw)
            got, want = (got,), (want,)
        for i, (g, w) in enumerate(zip(got, want)):
            restricted = variant == "restrict" and i == 1
            assert_close(g, w, 1e-11 if restricted else 0.0, 1e-11 if restricted else 1e-12, f"{variant}[{i}]")


def test_fused_smooth_rejects_bad_variants():
    op = to_port(jump_operator(14, 14))
    b = torch.zeros(op.aC.shape, dtype=torch.float64)
    with pytest.raises(ValueError):
        cuda_vcycle.fused_smooth(op, b, colors=(True,), residual=True, restrict=True)
    with pytest.raises(ValueError):
        cuda_vcycle.fused_smooth(op, b, colors=(True,), restrict=True)
    with pytest.raises(ValueError):
        cuda_vcycle.fused_smooth(op, b, colors=(True, False) * 4, residual=True)


@pytest.mark.parametrize("mode,depth", [("plain", 0), ("residual", 1), ("restrict", 2)])
def test_fused_smooth_halo_limit(mode, depth):
    """A phase whose halo (half-steps + residual depth) is MAX_HALO runs and
    equals its half-steps chained; one half-step more is refused, by the
    dispatch and by the kernel's wrapper before any launch."""
    jop = jump_operator(14, 14)
    op, tr = to_port(jop), to_port(_collapse(jop))
    b = T(np.random.default_rng(3).normal(size=jop.aC.shape))
    kw = dict(residual=mode == "residual", restrict=mode == "restrict", tr=tr if mode == "restrict" else None)
    n = cuda_vcycle.MAX_HALO - depth
    colors = (True, False) * (n // 2) + (True,) * (n % 2)
    got = cuda_vcycle.fused_smooth(op, b, colors=colors, **kw)
    x = torch.zeros_like(b)
    for red in colors:
        x = boxmg.color_update(op, x, b, red)
    want = {"plain": x, "residual": (x, b - boxmg.apply_any(op, x)),
            "restrict": (x, boxmg.restrict_box(tr, b - boxmg.apply_any(op, x)))}[mode]
    got, want = (got, want) if mode != "plain" else ((got,), (want,))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError):
        cuda_vcycle.fused_smooth(op, b, colors=colors + (False,), **kw)
    with pytest.raises(ValueError):
        cuda_vcycle.fused_smooth_cuda(op, b, colors=colors + (False,), **kw)


# the Pallas tail cycle in interpret mode under jit (one compile per pack
# shape and V(n_pre, n_post), no per-operation dispatch)
_jax_tail_cycle = jax.jit(functools.partial(pallas_tail.tail_cycle, interpret=True), static_argnums=(2, 3))


@pytest.mark.parametrize("shape,deep,pre_post", [((30, 22), False, (1, 1)), ((62, 30), True, (2, 2))])
def test_tail_cycle_twin_matches_pallas(shape, deep, pre_post):
    jop = jump_operator(*shape)
    levels = jax_levels(jop, deep=deep)
    assert 2 <= len(levels) <= boxmg.MAX_TAIL_LEVELS
    jpack = pallas_tail.build_tail_pack(levels, 0)
    pack = cuda_tail.pack_levels([to_port(lv.op) for lv in levels], [to_port(lv.tr) for lv in levels[:-1]])
    b = np.random.default_rng(5).normal(size=jop.aC.shape)
    want = _jax_tail_cycle(jpack, jnp.asarray(b), *pre_post)
    got = cuda_tail.tail_cycle(pack, T(b), *pre_post)
    scale = float(np.abs(np.asarray(want)).max())
    assert_close(got, want, 1e-12, 1e-12 * scale)


def galerkin_operator(nx, ny, seed):
    """The 9-point Galerkin coarse operator (JAX package, closed form) of
    the jump operator of an nx x ny box."""
    jop = jump_operator(nx, ny, seed=seed)
    return jax.jit(lambda op: jbox.galerkin_closed(op, jbox.collapse_weights(op), op.aC.shape))(jop)


# the tail-finest operators at the limits of the CUDA setup's row bands: a
# 5-point one of even sides (the remaining depth of its box, 2 levels) and
# a 9-point one of odd sides (3 levels, odd sides on two of them)
@pytest.mark.parametrize("case", ["5-point 32x24", "9-point 31x21"])
def test_tail_setup_twin_matches_pallas(case):
    if case == "5-point 32x24":
        jop = jump_operator(30, 22, seed=5)
        n = jbox._remaining_depth(jop.aC.shape, 0)
        assert n == 2
    else:
        jop, n = galerkin_operator(59, 39, seed=5), 3
    assert tuple(jop.aC.shape) == tuple(int(v) for v in case.split()[1].split("x"))
    jpack = jax.jit(functools.partial(pallas_tail.build_tail_pack_fused, n_levels=n, interpret=True))(jop)
    pack = cuda_tail.build_tail_pack(to_port(jop), n)
    assert pack.shapes == tuple(tuple(s) for s in pallas_tail._level_shapes(jop.aC.shape, n))
    b = np.random.default_rng(7).normal(size=jop.aC.shape)
    want = _jax_tail_cycle(jpack, jnp.asarray(b), 1, 1)
    got = cuda_tail.tail_cycle(pack, T(b))
    scale = float(np.abs(np.asarray(want)).max())
    assert_close(got, want, 1e-10, 1e-10 * scale)


def test_v_cycle_matches_xla_sweep_hierarchy():
    """The port's whole V-cycle (fused_smooth levels above the dense
    coarsest inverse) equals the JAX package's XLA V-cycle on its stock
    hierarchy, level for level, to 1e-12 relative; an f32 build of the same
    operator starts the tail at level 1 instead."""
    jop = drop_operator(170, 18)
    levels = boxmg.build_hierarchy(to_port(jop))
    jlevels = jax_levels(jop)
    assert [tuple(lv.op.aC.shape) for lv in levels] == [tuple(lv.op.aC.shape) for lv in jlevels]
    assert all(lv.tail is None for lv in levels) and jlevels[-1].coarse_inv is not None
    assert_close(levels[-1].coarse_inv, jlevels[-1].coarse_inv, 1e-12, 1e-12 * float(np.abs(jlevels[-1].coarse_inv).max()))
    f32 = boxmg.build_hierarchy(boxmg.cast_struct(to_port(jop), torch.float32))
    assert [lv.tail is not None for lv in f32] == [False, True] and f32[-1].coarse_inv is None
    b = np.random.default_rng(9).normal(size=jop.aC.shape)
    want = jax.jit(functools.partial(jbox.v_cycle, n_pre=2, n_post=2))(jlevels, jnp.asarray(b))
    got = boxmg.v_cycle(levels, T(b), n_pre=2, n_post=2)
    scale = float(np.abs(np.asarray(want)).max())
    assert_close(got, want, 1e-12, 1e-12 * scale)


@pytest.mark.parametrize("shape,expect", [
    ((1026, 1026), [1026, 513, 257, (129, 5)]),
    ((66, 66), [(66, 4)]),
    ((202, 182), [202, (101, 4)]),
    ((1026, 66), [1026, 513, 257, (129, 2)]),
])
def test_hierarchy_structure_from_shape(shape, expect):
    """Levels above the tail, then the tail start and depth, from shape alone."""
    got, n, m, built = [], shape[0], shape[1], 0
    while True:
        depth = boxmg._remaining_depth((n, m), built)
        if boxmg.tail_fits((n, m), depth):
            got.append((n, depth))
            break
        got.append(n)
        n, m, built = (n + 1) // 2, (m + 1) // 2, built + 1
    assert got == expect


def test_solve_pcg_matches_jax():
    """One pressure solve at 200 x 180 (fused_rap levels down to the dense
    coarsest inverse): the port's BoxMG-PCG against the JAX package's, tol
    1e-11: the same iteration count, x within 1e-12 of max|x|."""
    jop = drop_operator(200, 180, pin="right")
    rng = np.random.default_rng(21)
    b = rng.normal(size=jop.aC.shape)
    b[-1, :] = 0.0
    x0 = 0.1 * rng.normal(size=jop.aC.shape)
    jx, jrel, jit = jax.jit(functools.partial(
        jcg.solve_pcg, tol=1e-11, max_iter=100, singular=False, precond="boxmg", n_pre=2, n_post=2,
    ))(jop, jnp.asarray(b), x0=jnp.asarray(x0))
    x, rel, it = cg.solve_pcg(to_port(jop), T(b), tol=1e-11, max_iter=100, singular=False,
                              precond="boxmg", n_pre=2, n_post=2, x0=T(x0))
    assert float(rel) < 1e-11 and float(jrel) < 1e-11
    assert it == int(jit), (it, int(jit))
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-12 * np.abs(jx).max()


def drop_rhs(jop):
    b = np.random.default_rng(33).normal(size=jop.aC.shape)
    return b - b.mean()


def test_boxmg_pcg_matches_jax_stock_hierarchy():
    """The 64^2 drop operator (1000:1), f64, tol 1e-10, V(2,2): the port's
    stock hierarchy ends in the dense inverse where the JAX package's does,
    and its BoxMG-PCG takes the JAX package's 8 iterations and lands within
    1e-12 of its x (relative to max|x|)."""
    jop = drop_operator(64, 64)
    b = drop_rhs(jop)
    kw = dict(tol=1e-10, max_iter=100, singular=True, precond="boxmg", n_pre=2, n_post=2)
    jlevels = jax_levels(jop)
    jx, jrel, jit = jax.jit(functools.partial(jcg.solve_pcg, **kw))(jop, jnp.asarray(b), levels=jlevels)
    op = to_port(jop)
    levels = boxmg.build_hierarchy(op)
    assert [tuple(lv.op.aC.shape) for lv in levels] == [tuple(lv.op.aC.shape) for lv in jlevels]
    assert levels[-1].coarse_inv is not None and jlevels[-1].coarse_inv is not None
    x, rel, it = cg.solve_pcg(op, T(b), levels=levels, **kw)
    assert float(rel) < 1e-10 and float(jrel) < 1e-10
    assert it == int(jit) == 8, (it, int(jit))
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-12 * np.abs(jx).max()


def test_boxmg_pcg_iterations_match_jax_tail(monkeypatch):
    """The port's tail structure (its f64 tail pack built directly; the
    stock f64 build makes none) against the JAX package's run with the same
    structure: the JAX hierarchy's levels as ``pallas_tail.tail_cycle``
    (interpret mode) from level 0, as tests/test_pallas_tail.py runs it.
    The 64^2 drop operator (1000:1), f64, tol 1e-8: iteration counts within
    1, solutions within 1e-8 relative."""
    jop = drop_operator(64, 64)
    b = drop_rhs(jop)
    levels = jax_levels(jop)
    tl = [dataclasses.replace(lv) for lv in levels]
    tl[0].tail = pallas_tail.build_tail_pack(levels, 0)
    monkeypatch.setattr(pallas_tail, "tail_cycle", functools.partial(pallas_tail.tail_cycle, interpret=True))
    kw = dict(tol=1e-8, max_iter=100, singular=True, precond="boxmg", n_pre=2, n_post=2)
    jx, jrel, jit = jax.jit(functools.partial(jcg.solve_pcg, **kw))(jop, jnp.asarray(b), levels=tl)
    op = to_port(jop)
    n_rem = boxmg._remaining_depth(tuple(op.aC.shape), 0)
    assert boxmg.tail_fits(tuple(op.aC.shape), n_rem)
    port_levels = [boxmg.BoxLevel(op=op, tail=cuda_tail.build_tail_pack(op, n_rem))]
    assert port_levels[0].tail.shapes == tuple(tuple(lv.op.aC.shape) for lv in levels)
    x, rel, it = cg.solve_pcg(op, T(b), levels=port_levels, **kw)
    assert float(rel) < 1e-8 and float(jrel) < 1e-8
    assert abs(it - int(jit)) <= 1, (it, int(jit))
    jx = np.asarray(jx)
    assert np.abs(x.numpy() - jx).max() <= 1e-8 * np.abs(jx).max()


def test_dispatch_by_device():
    assert _kernels.on_cpu(torch.zeros(1))
    with pytest.raises(ValueError):
        _kernels.on_cpu(torch.zeros(1, device="meta"))
    with pytest.raises(TypeError):
        _kernels.dtype_code(torch.float16)
