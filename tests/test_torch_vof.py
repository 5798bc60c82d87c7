"""The port's VOF modules (PLIC, ELVIRA, curvature, advection and their
kernel twins) and its two-phase momentum and sampling functions against the
JAX package, in f64 on the CPU.

Inputs are made with numpy from a seed and handed to both packages. The
JAX side runs its CPU default (the sparse lane paths) and, once each, the
Pallas kernels in interpret mode. ELVIRA's winner can flip between two
candidates whose fit errors tie to rounding: the one such cell met here is
named in its test.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from fluidsolver_tpu.constants import vf_cutoffs as jvf_cutoffs
from fluidsolver_tpu.core import bc as jbc
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.ops import momentum as jmom
from fluidsolver_tpu.ops import stencil as jstencil
from fluidsolver_tpu.vof import advect as jadv
from fluidsolver_tpu.vof import curvature as jcurv
from fluidsolver_tpu.vof import pallas_elvira
from fluidsolver_tpu.vof import plic as jplic
from fluidsolver_tpu.vof.init import liquid_fraction_from_indicator as jfraction
from fluidsolver_tpu_torch.constants import vf_cutoffs
from fluidsolver_tpu_torch.core import bc
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ops import momentum as mom
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.vof import (advect, cuda_advect, cuda_curvature, cuda_elvira,
                                       curvature, plic)
from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator

torch.set_num_threads(1)


def T(a):
    return torch.as_tensor(np.array(a))


def assert_close(got, want, rtol, atol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol, err_msg=what)


def drops(x, y):
    return (((x - 0.45) ** 2 + (y - 0.62) ** 2 <= 0.27**2)
            | ((x - 0.2) ** 2 + (y - 0.2) ** 2 <= 0.1**2))


def vof_case(nx=37, ny=53, noise=0.02, seed=0):
    """Two circles on a (nx, ny) grid, the mixed cells perturbed by noise."""
    g = make_grid(0.0, 1.0, nx, 0.0, 1.3, ny)
    vf = liquid_fraction_from_indicator(drops, g)
    rng = np.random.default_rng(seed)
    mixed = (vf > 0) & (vf < 1)
    vf = np.clip(vf + noise * rng.standard_normal(vf.shape) * mixed, 0.0, 1.0)
    return g, jmake_grid(0.0, 1.0, nx, 0.0, 1.3, ny), vf


def swirl(g, scale=1.0):
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    Xv, Yv = np.meshgrid(g.xm, g.y, indexing="ij")
    return (scale * np.sin(np.pi * Xu) * np.cos(np.pi * Yu),
            -scale * np.cos(np.pi * Xv) * np.sin(np.pi * Yv))


def plic_to_torch(rec):
    return plic.Plic(T(rec.nx), T(rec.ny), T(rec.d), T(rec.valid),
                     overflow=torch.zeros((), dtype=torch.bool))


# ---- set-up and small helpers -------------------------------------------------
def test_vf_cutoffs_and_init_match():
    for dt, tdt in ((np.float32, torch.float32), (np.float64, torch.float64)):
        assert vf_cutoffs(tdt) == jvf_cutoffs(dt)
    assert vf_cutoffs(torch.float32)[0] == 2.0**-17
    g, jg, _ = vof_case(37, 53, noise=0.0)
    # the banded evaluation equals the JAX package's one-shot evaluation
    np.testing.assert_array_equal(liquid_fraction_from_indicator(drops, g), jfraction(drops, jg))


def test_scalar_ghost_fills():
    f = np.random.default_rng(1).normal(size=(9, 7))
    np.testing.assert_array_equal(bc.apply_neumann_scalar(T(f)).numpy(), jbc.apply_neumann_scalar(jnp.asarray(f)))
    np.testing.assert_array_equal(bc.apply_dirichlet_scalar(T(f), 2.5).numpy(),
                                  jbc.apply_dirichlet_scalar(jnp.asarray(f), 2.5))


def test_compact_indices_matches_nonzero():
    """First m True cells in row-major order, padded with the cell count,
    including a budget below the count (truncation) and above the grid."""
    rng = np.random.default_rng(7)
    for shape, m in (((37, 53), 64), ((37, 53), 2000), ((16, 16), 300)):
        mask = rng.random(shape) < 0.1
        fill = mask.size
        ri, rj = np.nonzero(mask)
        want = np.full(m, fill)
        k = min(m, ri.size)
        want[:k] = (ri * shape[1] + rj)[:k]
        np.testing.assert_array_equal(advect.compact_indices(T(mask), m).numpy(), want)


# ---- momentum, mixing, sampling -----------------------------------------------
def test_two_phase_momentum_functions():
    rng = np.random.default_rng(3)
    nx, ny, dx, dy = 11, 9, 0.1, 0.07
    U, V = rng.normal(size=(nx + 3, ny + 2)), rng.normal(size=(nx + 2, ny + 3))
    ru = np.where(rng.random(U.shape) < 0.5, 1.0, 1e3) + rng.random(U.shape)
    rv = np.where(rng.random(V.shape) < 0.5, 1.0, 1e3) + rng.random(V.shape)
    eps = mom.calc_rho_eps(1.0, 1e3)
    got = mom.calc_drhodt(T(U), T(V), T(ru), T(rv), dx, dy, eps)
    want = jmom.calc_drhodt(*(jnp.asarray(a) for a in (U, V, ru, rv)), dx, dy, eps)
    for a, b in zip(got, want):
        assert_close(a, b, 1e-13, 1e-10, "calc_drhodt")
    dt = 3e-3
    got = mom.update_density(T(ru), T(rv), got[0], got[1], torch.tensor(dt, dtype=torch.float64), T(U * 0), T(V * 0))
    want = jmom.update_density(jnp.asarray(ru), jnp.asarray(rv), want[0], want[1], dt, jnp.zeros(U.shape), jnp.zeros(V.shape))
    for a, b in zip(got, want):
        assert_close(a, b, 1e-14, 1e-12, "update_density")

    vf = np.clip(rng.normal(0.5, 0.6, size=(nx + 2, ny + 2)), 0.0, 1.0)
    vf[0, 0], vf[1, 1], vf[2, 2] = 1e-9, 1.0 - 1e-9, 0.3
    for a, b in zip(mom.mix_rho_staggered(T(vf), 1.0, 1e3),
                    jmom.mix_rho_staggered(jnp.asarray(vf), 1.0, 1e3, jnp.zeros(U.shape), jnp.zeros(V.shape))):
        assert_close(a, b, 1e-15, 0.0, "mix_rho_staggered")
    for arithmetic in (False, True):
        assert_close(mom.mix_visc(T(vf), 1e-6, 1e-3, arithmetic),
                     jmom.mix_visc(jnp.asarray(vf), 1e-6, 1e-3, arithmetic), 1e-14, 0.0, "mix_visc")

    curv = rng.normal(size=vf.shape) * 30.0
    length = np.where(rng.random(vf.shape) < 0.4, rng.random(vf.shape) * dx, 0.0)
    got = mom.calc_pressure_jump(T(vf), T(curv), T(length), 0.02, dx, dy)
    want = jmom.calc_pressure_jump(jnp.asarray(vf), jnp.asarray(curv), jnp.asarray(length), 0.02, dx, dy,
                                   jnp.zeros(U.shape), jnp.zeros(V.shape))
    for a, b in zip(got, want):
        assert_close(a, b, 1e-13, 1e-13, "calc_pressure_jump")


def test_sample_centered_matches():
    """Clamped bilinear sampling, also of points outside the domain."""
    rng = np.random.default_rng(4)
    g = make_grid(0.0, 1.0, 13, 0.0, 0.8, 10)
    f = rng.normal(size=(2, 15, 12))
    px, py = rng.uniform(-0.2, 1.2, size=(50, 4)), rng.uniform(-0.2, 1.0, size=(50, 4))
    args = (float(g.xm[1]), g.dx, float(g.ym[1]), g.dy)
    got = stencil.sample_centered_stack(T(f), *args, T(px), T(py))
    want = jstencil.sample_centered_stack(jnp.asarray(f), *args, jnp.asarray(px), jnp.asarray(py))
    assert_close(got, want, 1e-14, 1e-14, "sample_centered_stack")
    assert_close(stencil.sample_centered(T(f[0]), *args, T(px), T(py)),
                 jstencil.sample_centered(jnp.asarray(f[0]), *args, jnp.asarray(px), jnp.asarray(py)),
                 1e-14, 1e-14, "sample_centered")


# ---- PLIC and ELVIRA (kernel #10's twin) ----------------------------------------
def test_elvira_twin_matches_jax_default():
    """The dense twin against the JAX CPU default (sparse lanes) on every
    cell: valid exactly, the planes to rounding, the fills off the mixed
    set; interface length to rounding."""
    g, jg, vf = vof_case()
    got = plic.elvira(T(vf), g.dx, g.dy)
    want = jplic.elvira(jnp.asarray(vf), jg.dx, jg.dy)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) > 200 and not bool(got.overflow)
    for k in ("nx", "ny", "d"):
        assert_close(getattr(got, k), getattr(want, k), 1e-10, 1e-12, k)
    assert_close(plic.interface_length(got, g.dx, g.dy), jplic.interface_length(want, jg.dx, jg.dy),
                 1e-10, 1e-12, "interface_length")


def test_elvira_twin_matches_jax_default_all_mixed():
    """Every cell mixed (seeded noise in (0.02, 0.98)), so each tile of the
    CUDA kernel fills its list of mixed cells: the twin against the JAX CPU
    default, valid exactly and the planes to rounding; a cell may differ
    only at a near-tie, where both winners fit the neighbourhood equally
    well (the gap test of chip_smoke.check_elvira)."""
    import chip_smoke

    g = make_grid(0.0, 1.0, 37, 0.0, 1.3, 53)
    jg = jmake_grid(0.0, 1.0, 37, 0.0, 1.3, 53)
    vf = np.random.default_rng(29).uniform(0.02, 0.98, g.shape_center)
    got = cuda_elvira.elvira_twin(T(vf), g.dx, g.dy)
    want = jplic.elvira(jnp.asarray(vf), jg.dx, jg.dy)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    assert int(got.valid.sum()) == 37 * 53
    planes = [(getattr(got, k).numpy(), np.asarray(getattr(want, k))) for k in ("nx", "ny", "d")]
    off = np.zeros(vf.shape, bool)
    for a, b in planes:
        off |= ~np.isclose(a, b, rtol=1e-10, atol=1e-12)
    for a, b in planes:
        assert_close(a[~off], b[~off], 1e-10, 1e-12)
    if off.any():
        fit_twin = chip_smoke.fit_error(T(vf), got.nx, got.ny, got.d, g.dx, g.dy).numpy()
        fit_jax = chip_smoke.fit_error(T(vf), T(want.nx), T(want.ny), T(want.d), g.dx, g.dy).numpy()
        o = off[1:-1, 1:-1]
        gap = np.abs(fit_twin - fit_jax)[o] / (np.abs(fit_jax[o]) + 1e-12)
        assert gap.max() <= 1e-6


def test_elvira_twin_matches_pallas_interpret():
    """Once against the TPU kernel itself (interpret mode), at a shape of
    tests/test_pallas_elvira.py. One cell, (15, 38) with vf = 0.30298, is a
    near-tie: the kernel's winner (-0.78864, 0.61486) and the twin's
    (-0.79656, 0.60456), which is also the JAX CPU default's, fit the 3x3
    neighbourhood with errors 0.010241073090053111 and ...138, equal to
    2.7e-15 relative. Every other cell agrees to rounding."""
    import chip_smoke

    g, jg, vf = vof_case(62, 62, noise=0.0)
    got = cuda_elvira.elvira_twin(T(vf), g.dx, g.dy)
    want = pallas_elvira.elvira_pallas(jnp.asarray(vf), dx=jg.dx, dy=jg.dy, interpret=True)
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    planes = [(getattr(got, k).numpy(), np.asarray(getattr(want, k))) for k in ("nx", "ny", "d")]
    off = np.zeros(vf.shape, bool)
    for a, b in planes:
        off |= ~np.isclose(a, b, rtol=1e-10, atol=1e-12)
    assert list(zip(*np.nonzero(off))) == [(15, 38)]
    for a, b in planes:
        assert_close(a[~off], b[~off], 1e-10, 1e-12)
    fit_twin = chip_smoke.fit_error(T(vf), got.nx, got.ny, got.d, g.dx, g.dy).numpy()[14, 37]
    fit_kernel = chip_smoke.fit_error(T(vf), T(want.nx), T(want.ny), T(want.d), g.dx, g.dy).numpy()[14, 37]
    assert fit_kernel == pytest.approx(fit_twin, rel=1e-12)


def test_plic_geometry_round_trip():
    """plane_constant inverts area_fraction, degenerate normals included."""
    rng = np.random.default_rng(5)
    ang = np.concatenate([rng.uniform(0, 2 * np.pi, 400), np.arange(8) * np.pi / 4])
    frac = np.concatenate([rng.uniform(0, 1, 400), [0.0, 0.3, 0.5, 1.0, 0.7, 0.2, 0.9, 0.6]])
    nx_, ny_ = T(np.cos(ang)), T(np.sin(ang))
    d = plic.plane_constant(nx_, ny_, T(frac), 0.1, 0.07)
    assert_close(d, jplic.plane_constant(jnp.asarray(np.cos(ang)), jnp.asarray(np.sin(ang)),
                                         jnp.asarray(frac), 0.1, 0.07), 1e-13, 1e-15, "plane_constant")
    generic = np.abs(np.sin(2 * ang)) > 1e-6
    assert_close(plic.area_fraction(nx_, ny_, d, 0.1, 0.07).numpy()[generic], frac[generic], 0, 1e-12)


# ---- curvature (kernel #11's twin) ------------------------------------------------
def test_curvature_twin_matches_jax():
    """The dense twin against curvature_quad_volume_matching (sparse
    lanes) on the same reconstruction; the two libm acos differ by ulps."""
    g, jg, vf = vof_case()
    rec = jplic.elvira(jnp.asarray(vf), jg.dx, jg.dy)
    want = np.asarray(jcurv.curvature_quad_volume_matching(jnp.asarray(vf), rec, jg))
    got = curvature.curvature_quad_volume_matching(T(vf), plic_to_torch(rec), g).numpy()
    scale = np.abs(want).max()
    assert scale > 1.0 and np.count_nonzero(want) > 200
    assert_close(got, want, 1e-10, 1e-12 * scale, "curvature")
    np.testing.assert_array_equal(got[~np.asarray(rec.valid)], 0.0)


def curvature_limit_fields(g):
    """vf of the limit inputs of the curvature kernel on the grid ``g``: a
    lone mixed cell in a 0 / 1 step (fewer than two segments: 0), every
    cell mixed (seeded noise in (0.02, 0.98)), and drops centred on the
    walls, so that valid cells lie beside the ghost ring on every side."""
    n, m = g.shape_center
    lone = np.where(np.arange(n)[:, None] < n // 2, 0.0, 1.0) * np.ones((n, m))
    lone[n // 2 - 1, m // 2] = 0.4
    X, Y = np.meshgrid(g.xm, g.ym, indexing="ij")
    phi = np.full(X.shape, np.inf)
    for cx, cy in ((0.0, 0.65), (1.0, 0.4), (0.5, 0.0), (0.3, 1.3)):
        phi = np.minimum(phi, np.hypot(X - cx, Y - cy) - 0.2)
    return {"lone mixed cell": lone,
            "every cell mixed": np.random.default_rng(29).uniform(0.02, 0.98, (n, m)),
            "beside the ghost ring": np.clip(0.5 - phi / (2 * max(g.dx, g.dy)), 0.0, 1.0)}


@pytest.mark.parametrize("name", ["lone mixed cell", "every cell mixed", "beside the ghost ring"])
def test_curvature_twin_matches_jax_limit_fields(name):
    """The twin, which the CUDA kernel is held to on the card, against
    curvature_quad_volume_matching on the same planes at the limits of the
    kernel's per-block list: no second segment, a full list, neighbours on
    the ghost ring."""
    g, jg, _ = vof_case()
    vf = curvature_limit_fields(g)[name]
    rec = jplic.elvira(jnp.asarray(vf), jg.dx, jg.dy)
    valid = np.asarray(rec.valid)
    want = np.asarray(jcurv.curvature_quad_volume_matching(jnp.asarray(vf), rec, jg))
    got = cuda_curvature.curvature_vm_twin(T(rec.nx), T(rec.ny), T(rec.d), T(valid), g.dx, g.dy).numpy()
    assert_close(got, want, 1e-10, 1e-12 * np.abs(want).max(), name)
    np.testing.assert_array_equal(got[~valid], 0.0)
    if name == "lone mixed cell":
        assert valid.sum() == 1 and not got.any()
    elif name == "every cell mixed":
        assert valid[1:-1, 1:-1].all() and np.count_nonzero(want) > 1500
    else:
        assert all(e.any() for e in (valid[1], valid[-2], valid[:, 1], valid[:, -2]))
        assert np.count_nonzero(got[1]) and np.count_nonzero(got[:, 1])


# ---- advection (kernel #12's twin) ------------------------------------------------
def advect_inputs(g, vf, dt_frac=0.5):
    U, V = swirl(g)
    Ut, Vt = T(U), T(V)
    dt = dt_frac * g.dx
    return (Ut, Vt, stencil.interp_u_center(Ut), stencil.interp_v_center(Vt),
            torch.tensor(dt, dtype=torch.float64), dt)


@pytest.mark.parametrize("mode", ["off", "interpret"])
def test_overlap_twin_matches_jax(mode, monkeypatch):
    """The clip chain on the same lanes against advect._overlap_sparse:
    its XLA chain ("off") and once the TPU kernel in interpret mode."""
    monkeypatch.setattr(jadv, "_PALLAS_OVERRIDE", mode)
    g, jg, vf = vof_case()
    rec = plic.elvira(T(vf), g.dx, g.dy)
    Ut, Vt, Ui, Vi, dt_t, _ = advect_inputs(g, vf)
    m = advect.default_max_active(g.nx, g.ny)
    lanes = advect.prepare_lanes(T(vf), Ut, Vt, Ui, Vi, g, dt_t, m)
    got_ov, got_area = cuda_advect.overlap(lanes.slots_x, lanes.slots_y, T(vf), rec,
                                           lanes.iig, lanes.jjg, g.dx, g.dy)
    gathered = cuda_advect.gather_neighbourhood(T(vf), rec, lanes.iig, lanes.jjg).numpy()
    want_ov, want_area = jadv._overlap_sparse(
        [jnp.asarray(s) for s in lanes.slots_x.numpy()], [jnp.asarray(s) for s in lanes.slots_y.numpy()],
        jnp.asarray(gathered), g.dx, g.dy, jnp.float64)
    assert int(lanes.n_active) > 500
    assert_close(got_ov, want_ov, 0.0, 1e-13, "overlap")
    assert_close(got_area, want_area, 1e-10, 1e-15, "start area")


def test_overlap_twin_matches_jax_liquid_corner(monkeypatch):
    """Fill lanes that do work: a liquid drop over the last interior corner,
    which the fill lanes gather through clamped indices. The twin against
    advect._overlap_sparse on every lane; and each (lane, neighbour) pair
    below the cutoff, taken alone (the other neighbours' fractions set to
    0), gives +0 in both packages: the CUDA kernel runs no clip chain for
    such a pair and leaves +0 in its slot."""
    monkeypatch.setattr(jadv, "_PALLAS_OVERRIDE", "off")
    g, jg, vf = vof_case()
    X, Y = np.meshgrid(g.xm, g.ym, indexing="ij")
    vf = np.maximum(vf, np.clip(0.5 - (np.hypot(X - g.xm[-2], Y - g.ym[-2]) - 0.15) / g.dx, 0.0, 1.0))
    rec = plic.elvira(T(vf), g.dx, g.dy)
    Ut, Vt, Ui, Vi, dt_t, _ = advect_inputs(g, vf)
    lanes = advect.prepare_lanes(T(vf), Ut, Vt, Ui, Vi, g, dt_t, advect.default_max_active(g.nx, g.ny))
    got_ov, got_area = cuda_advect.overlap_twin(lanes.slots_x, lanes.slots_y, T(vf), rec,
                                                lanes.iig, lanes.jjg, g.dx, g.dy)
    gathered = cuda_advect.gather_neighbourhood(T(vf), rec, lanes.iig, lanes.jjg).numpy()
    lo, _ = vf_cutoffs(torch.float64)
    fill = lanes.is_fill.numpy()
    assert fill.sum() > 500 and (gathered[0][:, fill] > lo).all(axis=0).any()
    sx = [jnp.asarray(s) for s in lanes.slots_x.numpy()]
    sy = [jnp.asarray(s) for s in lanes.slots_y.numpy()]
    want_ov, want_area = jadv._overlap_sparse(sx, sy, jnp.asarray(gathered), g.dx, g.dy, jnp.float64)
    assert_close(got_ov, want_ov, 0.0, 1e-13, "overlap")
    assert_close(got_area, want_area, 1e-10, 1e-15, "start area")
    assert np.count_nonzero(got_ov.numpy()[fill]) > 0

    vx, vy, n = advect.pad_slots(lanes.slots_x, lanes.slots_y)
    below = gathered[0] <= lo
    assert below.any() and (~below).any()
    for k in range(9):
        alone = gathered.copy()
        alone[0] = 0.0
        alone[0, k] = gathered[0, k]
        got_k = advect.overlap_from_neighbors(vx, vy, n, T(alone), g.dx, g.dy).numpy()
        want_k = np.asarray(jadv._overlap_sparse(sx, sy, jnp.asarray(alone), g.dx, g.dy, jnp.float64)[0])
        for r in (got_k[below[k]], want_k[below[k]]):
            assert np.all(r == 0.0) and not np.signbit(r).any()


def test_advect_matches_jax():
    """advect end to end (vf and the volume error), and the overflow case:
    a budget below the active set gives an infinite volume error."""
    g, jg, vf = vof_case()
    Ut, Vt, Ui, Vi, dt_t, dt = advect_inputs(g, vf)
    jrec = jplic.elvira(jnp.asarray(vf), jg.dx, jg.dy)
    rec = plic.elvira(T(vf), g.dx, g.dy)
    jargs = (jnp.asarray(Ut.numpy()), jnp.asarray(Vt.numpy()), jnp.asarray(Ui.numpy()), jnp.asarray(Vi.numpy()))
    for budget in (None, 300):
        got, err = advect.advect(T(vf), rec, Ut, Vt, Ui, Vi, g, dt_t, max_active=budget)
        want, jerr = jadv.advect(jnp.asarray(vf), jrec, *jargs, jg, dt, max_active=budget)
        assert_close(got, want, 0.0, 1e-13, "vf")
        if budget is None:
            assert 0.0 <= float(err) < 1e-8
            assert float(err) == pytest.approx(float(jerr), rel=1e-6, abs=1e-16)
        else:
            assert np.isinf(float(err)) and np.isinf(float(jerr))


def test_advect_conserves_translated_circle():
    """Constant velocity: volume error and mass drift at rounding, vf in
    [0, 1] (the JAX package's kernel invariants test)."""
    g = make_grid(0.0, 1.0, 48, 0.0, 1.0, 48)
    vf = T(liquid_fraction_from_indicator(lambda x, y: (x - 0.3) ** 2 + (y - 0.3) ** 2 <= 0.125**2, g))
    U, V = torch.full(g.shape_u, 1.0, dtype=torch.float64), torch.full(g.shape_v, 0.5, dtype=torch.float64)
    Ui, Vi = stencil.interp_u_center(U), stencil.interp_v_center(V)
    mass0 = float(vf.sum())
    for _ in range(4):
        vf, err = advect.advect(vf, plic.elvira(vf, g.dx, g.dy), U, V, Ui, Vi, g,
                                torch.tensor(5e-3, dtype=torch.float64))
        assert float(err) < 1e-12
        assert float(vf.min()) >= -1e-12 and float(vf.max()) <= 1.0 + 1e-12
    assert abs(float(vf.sum()) - mass0) * g.dx * g.dy <= 1e-12


def test_kernel_modules_dispatch_by_device():
    """A CPU tensor runs the twin; a tensor on a device with no kernel
    raises instead of falling back."""
    vf = torch.zeros((8, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError):
        cuda_elvira.elvira(vf, 0.1, 0.1)
    with pytest.raises(ValueError):
        cuda_curvature.curvature_vm(vf, vf, vf, vf.bool(), 0.1, 0.1)
    rec = plic.Plic(vf, vf, vf, vf.bool(), overflow=torch.zeros((), dtype=torch.bool))
    lanes = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError):
        cuda_advect.overlap(torch.zeros((8, 4), dtype=torch.float64, device="meta"),
                            torch.zeros((8, 4), dtype=torch.float64, device="meta"),
                            vf, rec, lanes, lanes, 0.1, 0.1)
