"""The port's distributed BoxMG-PCG (``parallel/dist_poisson.py``) and its
slab smoother (``parallel/cuda_shard.py``) against the port's single-device
solve and kernel twins and against the JAX package, on the JAX tests'
eight-device CPU mesh (``SlabMesh(["cpu"] * 8)`` beside it), in f64.

The slab smoother runs the single-device phase on halo-extended slabs and
crops, so it is held bitwise to the port's global ``fused_smooth`` and to
the chained ``_sweep_local``. The distributed hierarchy is the
single-device one on real rows (bitwise on the CPU), down to the gathered
levels' dense coarsest inverse, as in the JAX package's CPU path. So the
distributed solve takes the port's single-device iterations and the JAX
package's distributed ones, and its solution is held to both at 1e-12
relative (measured 5.6e-15 at most against JAX, at tol 1e-8).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from fluidsolver_tpu.parallel import dist_poisson as jdp
from fluidsolver_tpu.parallel import pallas_shard as jps
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.parallel import cuda_shard, dist_poisson
from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
from fluidsolver_tpu_torch.poisson import boxmg, cg, cuda_vcycle
from fluidsolver_tpu_torch.poisson.linsys import StencilOp, apply_op
from tests.test_dist_poisson import _jump_system

torch.set_num_threads(1)
MESH = SlabMesh(["cpu"] * 8)


def T(a, dtype=None):
    return torch.as_tensor(np.array(a), dtype=dtype)


def port_system(n, pin, dtype=torch.float64):
    jop, jrhs = _jump_system(n, pin)
    op = StencilOp(**{f.name: T(getattr(jop, f.name), dtype) for f in dataclasses.fields(jop)})
    return jop, jrhs, op, T(jrhs, dtype)


def centred(a, singular):
    a = np.asarray(a)
    return a - a.mean() if singular else a


def test_make_plan_raises_below_two_devices():
    with pytest.raises(ValueError, match=">= 2 devices"):
        dist_poisson.make_plan(66, 66, 1)
    with pytest.raises(ValueError, match="too thin"):
        dist_poisson.make_plan(10, 66, 8)


@pytest.mark.parametrize("shape", [(66, 66, 8), (35, 35, 4), (1026, 1026, 4), (2405, 450, 4)])
def test_make_plan_matches_jax(shape):
    got, want = dist_poisson.make_plan(*shape), jdp.make_plan(*shape)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.mx == want.mx


@pytest.mark.parametrize("n,pin", [(64, "right"), (64, None), (33, "left")])
def test_dist_pcg_matches_single_device_and_jax(n, pin):
    """The iterations of the port's single-device BoxMG-PCG and of JAX's
    distributed solve, both solutions within 1e-12."""
    jop, jrhs, op, rhs = port_system(n, pin)
    singular, tol = pin is None, 1e-8
    x_s, rel_s, it_s = cg.solve_pcg(op, rhs, tol=tol, max_iter=200, singular=singular,
                                    precond="boxmg")
    x_d, rel_d, it_d = dist_poisson.solve_pcg_sharded(MESH, op, rhs, tol=tol, max_iter=200,
                                                      singular=singular)
    assert it_s < 200 and it_d == it_s, (it_s, it_d)
    assert float(rel_d) <= tol and x_d.shape == rhs.shape
    a, b = centred(x_s, singular), centred(x_d, singular)
    assert np.abs(a - b).max() <= 1e-12 * np.abs(a).max()

    x_j, rel_j, it_j = jdp.solve_pcg_sharded(Mesh(np.array(jax.devices()), ("x",)), jop, jrhs,
                                             tol=tol, max_iter=200, singular=singular)
    c = centred(x_j, singular)
    assert it_d == int(it_j), (it_d, int(it_j))
    assert np.abs(b - c).max() <= 1e-12 * np.abs(c).max()
    # the true residual of the distributed solution
    r = rhs - apply_op(op, x_d)
    if singular:
        r = r - r.mean()
    assert float(torch.linalg.norm(r) / torch.linalg.norm(rhs)) < 5 * tol


def test_dist_pcg_host_reads_and_warm_start():
    """One counted host read per iteration and one for the exit test; a
    converged warm start exits within one iteration."""
    _, _, op, rhs = port_system(48, "right")
    before = sync.count
    x1, _, it1 = dist_poisson.solve_pcg_sharded(MESH, op, rhs, tol=1e-8, max_iter=200,
                                                singular=False)
    assert sync.count - before == it1 + 1
    _, rel2, it2 = dist_poisson.solve_pcg_sharded(MESH, op, rhs, tol=1e-6, max_iter=200,
                                                  singular=False, x0=x1)
    assert it1 > 3 and it2 <= 1, (it1, it2)
    assert float(rel2) <= 1e-6


@pytest.mark.parametrize("pin", ["right", None])
def test_dist_pcg_prebuilt_levels(pin):
    """A prebuilt hierarchy is the in-solve build: the same iterations and
    the same solution, bit for bit."""
    _, _, op, rhs = port_system(64, pin)
    kw = dict(tol=1e-8, max_iter=200, singular=pin is None)
    x1, rel1, it1 = dist_poisson.solve_pcg_sharded(MESH, op, rhs, **kw)
    levels = dist_poisson.build_hierarchy_sharded(MESH, op)
    x2, rel2, it2 = dist_poisson.solve_pcg_sharded(MESH, op, rhs, levels=levels, **kw)
    assert it1 == it2
    assert torch.equal(x1, x2) and torch.equal(rel1, rel2)


def test_dist_pcg_f32():
    _, _, op, rhs = port_system(64, "right", torch.float32)
    x, rel, it = dist_poisson.solve_pcg_sharded(MESH, op, rhs, tol=1e-4, max_iter=100,
                                                singular=False)
    assert x.dtype == torch.float32
    assert float(rel) <= 1e-4 and it < 100


def test_dist_levels_are_the_single_device_levels():
    """Every distributed level, gathered and cropped to its real rows, is
    the single-device ``build_hierarchy(tail=False)`` level bitwise, and
    the gathered tail starts at level ``L_dist`` and ends in the single-device
    dense coarsest inverse, bitwise."""
    _, _, op, _ = port_system(64, None)
    plan = dist_poisson.make_plan(*op.aC.shape, len(MESH))
    levels, tail = dist_poisson.build_hierarchy_sharded(MESH, op)
    single = boxmg.build_hierarchy(op, tail=False)
    assert len(levels) == plan.L_dist
    for lvl, dl in enumerate(levels):
        for name in boxmg.COEF_NAMES[:len(boxmg.coefs(dl.op[0]))]:
            got = torch.cat([getattr(o, name) for o in dl.op])[:plan.n_real[lvl]]
            assert torch.equal(got, getattr(single[lvl].op, name)), (lvl, name)
    for name in boxmg.COEF_NAMES:
        assert torch.equal(getattr(tail[0].op, name), getattr(single[plan.L_dist].op, name))
    assert len(levels) + len(tail) == len(single) and torch.equal(tail[-1].coarse_inv, single[-1].coarse_inv)


SMOOTH_CASES = [((True, False), False), ((True, False, False, True), True),
                ((True, False) * 2, True), ((False, True) * 2, False)]


@pytest.mark.parametrize("colors,residual", SMOOTH_CASES)
def test_sharded_smoother_is_the_global_phase(colors, residual):
    """``make_sharded_smoother`` on the 64^2 box (8-row slabs) and on its
    coarse 9-point level (32^2 over 4 slabs), f32: bitwise the port's global
    ``fused_smooth``; on the box also bitwise the chained colour updates
    with a halo refresh per colour."""
    _, _, op, rhs = port_system(62, "right", torch.float32)
    x0 = T(np.random.default_rng(1).normal(size=rhs.shape), torch.float32)
    coarse = boxmg.build_hierarchy(op, tail=False)[1].op
    outs = []
    for mesh, o, b, x in ((MESH, op, rhs, x0), (SlabMesh(["cpu"] * 4), coarse, rhs[:32, :32], x0[:32, :32])):
        out = cuda_shard.make_sharded_smoother(mesh, colors, residual=residual)(o, b, x)
        ref = cuda_vcycle.fused_smooth(o, b, x0=x, colors=colors, residual=residual)
        for got, want in zip(out if residual else (out,), ref if residual else (ref,)):
            assert torch.equal(got, want)
        outs.append(out)
    out = outs[0]

    rows = rhs.shape[0] // len(MESH)
    ops = dist_poisson._split_op(MESH, op, rows)
    ops_ext = dist_poisson._extend_op(MESH, ops, 1)
    bs, chained = list(rhs.split(rows)), list(x0.split(rows))
    for red in colors:
        ax = dist_poisson._apply_local(MESH, ops_ext, chained)
        chained = [torch.where(boxmg.red_mask(x.shape, x.device) == red,
                               (b - (a - o.aC * x)) / boxmg._safe(o.aC), x)
                   for o, x, b, a in zip(ops, chained, bs, ax)]
    x_sh = out[0] if residual else out
    assert torch.equal(x_sh, torch.cat(chained))
    if residual:
        r = [b - a for b, a in zip(bs, dist_poisson._apply_local(MESH, ops_ext, chained))]
        assert torch.equal(out[1], torch.cat(r))


def test_sweep_local_is_two_colour_updates():
    """``_sweep_local`` forward and reverse: bitwise the slab smoother's
    (red, black) and (black, red) phases."""
    _, _, op, rhs = port_system(62, None)
    x0 = T(np.random.default_rng(2).normal(size=rhs.shape))
    rows = rhs.shape[0] // len(MESH)
    ops = dist_poisson._split_op(MESH, op, rows)
    for reverse, colors in ((False, (True, False)), (True, (False, True))):
        got = dist_poisson._sweep_local(MESH, ops, list(x0.split(rows)), list(rhs.split(rows)),
                                        reverse=reverse)
        want = cuda_shard.make_sharded_smoother(MESH, colors)(op, rhs, x0)
        assert torch.equal(torch.cat(got), want)


def test_sharded_smoother_matches_jax_interpret():
    """Against the JAX package's ``make_sharded_smoother`` (Pallas in
    interpret mode) on the same 64^2 f64 inputs: a pre-smoothing phase with
    its residual, to 1e-13 of the field."""
    jop, jrhs, op, rhs = port_system(62, "right")
    x0 = np.random.default_rng(3).normal(size=rhs.shape)
    colors = (True, False, False, True)
    jx, jr = jps.make_sharded_smoother(Mesh(np.array(jax.devices()), ("x",)), colors,
                                       residual=True, interpret=True)(jop, jrhs, jnp.asarray(x0))
    x, r = cuda_shard.make_sharded_smoother(MESH, colors, residual=True)(op, rhs, T(x0))
    for got, want in ((x, jx), (r, jr)):
        want = np.asarray(want)
        assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()


def test_extend_helpers_are_the_zero_padded_rows():
    """``_extend_op`` and ``_extend_tr`` give each slab the rows of the
    zero-padded global planes around it."""
    _, _, op, _ = port_system(62, "right")
    tr = boxmg.collapse_weights(op)
    for obj, extend, rows in ((op, dist_poisson._extend_op, 8), (tr, dist_poisson._extend_tr, 4)):
        names = [f.name for f in dataclasses.fields(obj)]
        slabs = [type(obj)(**{k: getattr(obj, k)[i * rows:(i + 1) * rows] for k in names})
                 for i in range(len(MESH))]
        for i, ext in enumerate(extend(MESH, slabs, 2)):
            for k in names:
                padded = torch.nn.functional.pad(getattr(obj, k), (0, 0, 2, 2))
                assert torch.equal(getattr(ext, k), padded[i * rows:i * rows + rows + 4])
