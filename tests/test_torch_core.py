"""The PyTorch port's core, stencil, momentum, state and pressure-system
assembly against the JAX package, on the same seeded numpy inputs in f64.

Tolerance 1e-13: the port evaluates the same expressions in the same
floating-point order, so only reduction order (sums, maxima) can differ.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fluidsolver_tpu.core import bc as jbc
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.ops import momentum as jmom
from fluidsolver_tpu.ops import stencil as jst
from fluidsolver_tpu.poisson import linsys as jlin
from fluidsolver_tpu.solvers import config as jconfig
from fluidsolver_tpu.solvers import state as jstate
from fluidsolver_tpu_torch.core import bc as tbc
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.ops import momentum as tmom
from fluidsolver_tpu_torch.ops import stencil as tst
from fluidsolver_tpu_torch.poisson import linsys as tlin
from fluidsolver_tpu_torch.solvers import state as tstate
from fluidsolver_tpu_torch.solvers.config import SolverConfig, config_from_jax

torch.set_num_threads(1)
TOL = 1e-13
G = make_grid(0.0, 1.0, 9, 0.0, 1.3, 7)
JG = jmake_grid(0.0, 1.0, 9, 0.0, 1.3, 7)


def T(a):
    return torch.as_tensor(np.array(a))


def close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol * scale, np.abs(got - want).max()


def _fields(seed):
    rng = np.random.default_rng(seed)
    return dict(
        U=rng.normal(size=G.shape_u), V=rng.normal(size=G.shape_v),
        rho_u=np.where(rng.random(G.shape_u) > 0.5, 1000.0, 1.0),
        rho_v=np.where(rng.random(G.shape_v) > 0.5, 1000.0, 1.0),
        visc=rng.random(G.shape_center) + 0.1, p=rng.normal(size=G.shape_center),
        pj_u=rng.normal(size=G.shape_u), pj_v=rng.normal(size=G.shape_v),
        U_old=rng.normal(size=G.shape_u), V_old=rng.normal(size=G.shape_v),
    )


def test_grid_matches():
    for name in ("dx", "dy", "shape_center", "shape_u", "shape_v"):
        assert getattr(G, name) == getattr(JG, name)
    for name in ("x", "xm", "y", "ym"):
        np.testing.assert_array_equal(getattr(G, name), getattr(JG, name))


def test_stencil_matches():
    f = _fields(1)
    U, V, p = f["U"], f["V"], f["p"]
    close(tst.interp_u_center(T(U)), jst.interp_u_center(jnp.asarray(U)))
    close(tst.interp_v_center(T(V)), jst.interp_v_center(jnp.asarray(V)))
    close(tst.interp_uv_center(T(U), T(V)), jst.interp_uv_center(jnp.asarray(U), jnp.asarray(V)))
    close(tst.divergence(T(U), T(V), G.dx, G.dy), jst.divergence(jnp.asarray(U), jnp.asarray(V), G.dx, G.dy))
    close(tst.mid_time(T(U), T(f["U_old"])), jst.mid_time(jnp.asarray(U), jnp.asarray(f["U_old"])))
    close(tst.shift_pressure_to_zero(T(p), G.dx, G.dy), jst.shift_pressure_to_zero(jnp.asarray(p), G.dx, G.dy))


def _inflow(y, t):
    # the same expression on jax and torch arrays
    return 4.0 * y * (1.3 - y) + 0.5 * t


# (port BC, JAX BC) per variant; each is applied on all four sides
_BCS = {
    "dirichlet_const": (tbc.Dirichlet(u=0.7, v=-0.3), jbc.Dirichlet(u=0.7, v=-0.3)),
    "dirichlet_callable": (tbc.Dirichlet(u=_inflow, v=0.2), jbc.Dirichlet(u=_inflow, v=0.2)),
    "neumann": (tbc.Neumann(), jbc.Neumann()),
    "neumann_clipped": (tbc.Neumann(clipped=True), jbc.Neumann(clipped=True)),
    "periodic": (tbc.Periodic(), jbc.Periodic()),
    "symmetry": (tbc.Symmetry(), jbc.Symmetry()),
}


@pytest.mark.parametrize("variant", sorted(_BCS))
def test_velocity_bcs_match(variant):
    tb, jb = _BCS[variant]
    f = _fields(2)
    for t in (0.0, 0.37):
        U, V = tbc.apply_velocity_bcs(T(f["U"]), T(f["V"]), G, tbc.FlowBCs(tb, tb, tb, tb), t=t)
        JU, JV = jbc.apply_velocity_bcs(jnp.asarray(f["U"]), jnp.asarray(f["V"]), JG,
                                        jbc.FlowBCs(jb, jb, jb, jb), t=t)
        close(U, JU)
        close(V, JV)


def test_mixed_bcs_match():
    f = _fields(3)
    tb = tbc.FlowBCs(tbc.Dirichlet(u=_inflow), tbc.Neumann(clipped=True), tbc.Symmetry(), tbc.Dirichlet(u=1.0))
    jb = jbc.FlowBCs(jbc.Dirichlet(u=_inflow), jbc.Neumann(clipped=True), jbc.Symmetry(), jbc.Dirichlet(u=1.0))
    U, V = tbc.apply_velocity_bcs(T(f["U"]), T(f["V"]), G, tb, t=T(0.25))
    JU, JV = jbc.apply_velocity_bcs(jnp.asarray(f["U"]), jnp.asarray(f["V"]), JG, jb, t=jnp.asarray(0.25))
    close(U, JU)
    close(V, JV)


def test_momentum_matches():
    f = _fields(4)
    rho_eps = tmom.calc_rho_eps(1.0, 1000.0)
    assert rho_eps == jmom.calc_rho_eps(1.0, 1000.0)
    names = ("U", "V", "rho_u", "rho_v", "visc", "p", "pj_u", "pj_v")
    du, dv = tmom.calc_dmomdt(*(T(f[n]) for n in names), G.dx, G.dy, rho_eps)
    jdu, jdv = jmom.calc_dmomdt(*(jnp.asarray(f[n]) for n in names), G.dx, G.dy, rho_eps)
    close(du, jdu)
    close(dv, jdv)

    args = ("U_old", "V_old", "rho_u", "rho_v", "rho_u", "rho_v")
    U, V = tmom.update_velocity(*(T(f[n]) for n in args), du, dv, 3e-3, T(f["U"]), T(f["V"]))
    JU, JV = jmom.update_velocity(*(jnp.asarray(f[n]) for n in args), jdu, jdv, 3e-3,
                                  jnp.asarray(f["U"]), jnp.asarray(f["V"]))
    close(U, JU)
    close(V, JV)

    for sigma in (0.0, 0.02):
        dt = tmom.adjust_dt(T(f["U"]), T(f["V"]), T(f["rho_u"]), T(f["rho_v"]), T(f["visc"]),
                            G.dx, G.dy, 1.0, 1000.0, sigma, 0.5, 1e-2)
        jdt = jmom.adjust_dt(*(jnp.asarray(f[n]) for n in ("U", "V", "rho_u", "rho_v", "visc")),
                             G.dx, G.dy, 1.0, 1000.0, sigma, 0.5, 1e-2)
        close(dt, jdt)

    got = tmom.inflow_outflow(T(f["U"]), T(f["rho_u"]))
    want = jmom.inflow_outflow(jnp.asarray(f["U"]), jnp.asarray(f["rho_u"]))
    for g, w in zip(got, want):
        close(g, w)
    close(tmom.correct_outflow(T(f["U"]), T(f["rho_u"]), got[2]),
          jmom.correct_outflow(jnp.asarray(f["U"]), jnp.asarray(f["rho_u"]), want[2]))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_time_clamp_matches(dtype):
    tdt = torch.float32 if dtype == np.float32 else torch.float64
    t_end = 0.1
    assert tstate.end_tolerance(tdt, t_end) == jstate.end_tolerance(dtype, t_end)
    eps = float(np.finfo(dtype).eps)
    for t in (0.0, 0.05, t_end - 3 * eps * t_end, t_end - 1e-3):
        for dt in (1e-2, 2e-2):
            got = tstate.clamp_dt_to_end(torch.tensor(dt, dtype=tdt), torch.tensor(t, dtype=tdt), t_end)
            want = jstate.clamp_dt_to_end(jnp.asarray(dt, dtype), jnp.asarray(t, dtype), t_end)
            assert float(got) == float(want), (t, dt, float(got), float(want))


def test_state_round_trip():
    js = jstate.init_flow_state(JG, 1.3, 2e-3, dtype=np.float64)
    ts = tstate.init_flow_state(G, 1.3, 2e-3, torch.float64, "cpu")
    for name, arr in tstate.state_to_numpy(ts).items():
        want = np.asarray(getattr(js, name))
        assert arr.dtype == want.dtype, name
        np.testing.assert_array_equal(arr, want)
    f = _fields(5)
    js = dataclasses.replace(js, U=jnp.asarray(f["U"]), p=jnp.asarray(f["p"]), t=jnp.asarray(0.25))
    back = tstate.state_to_numpy(tstate.state_from_numpy(js, "cpu"))
    for name in back:
        np.testing.assert_array_equal(back[name], np.asarray(getattr(js, name)))


@pytest.mark.parametrize("pin", [None, "left", "right", "bottom", "top"])
def test_pressure_system_matches(pin):
    f = _fields(6)
    op = tlin.assemble_pressure_operator(T(f["rho_u"]), T(f["rho_v"]), G.dx, G.dy, pin)
    jop = jlin.assemble_pressure_operator(jnp.asarray(f["rho_u"]), jnp.asarray(f["rho_v"]), G.dx, G.dy, pin)
    for name in ("aC", "aL", "aR", "aB", "aT"):
        close(getattr(op, name), getattr(jop, name))
    close(tlin.apply_op(op, T(f["p"])), jlin.apply_op(jop, jnp.asarray(f["p"])))
    div = f["visc"] - 0.6
    for per in ((False, False), (True, False), (False, True), (True, True)):
        rhs = tlin.build_pressure_rhs(T(div), G.dx, G.dy, T(3e-3), pin, *per)
        jrhs = jlin.build_pressure_rhs(jnp.asarray(div), G.dx, G.dy, jnp.asarray(3e-3), pin, *per)
        close(rhs, jrhs)


def test_config_from_jax():
    jcfg = jconfig.SolverConfig(
        rho_liquid=1e3, pressure_tol=1e-9, pressure_pin="right", gravity=(0.0, -1.0),
        bcs=jbc.FlowBCs(jbc.Dirichlet(u=1.0), jbc.Neumann(clipped=True), jbc.Periodic(), jbc.Symmetry()),
    )
    cfg = config_from_jax(jcfg)
    assert isinstance(cfg, SolverConfig)
    assert cfg.bcs == tbc.FlowBCs(tbc.Dirichlet(u=1.0), tbc.Neumann(clipped=True), tbc.Periodic(), tbc.Symmetry())
    for fld in dataclasses.fields(SolverConfig):
        if fld.name != "bcs":
            assert getattr(cfg, fld.name) == getattr(jcfg, fld.name), fld.name
    with pytest.raises(ValueError):
        config_from_jax(dataclasses.replace(jcfg, bcs=jbc.FlowBCs(
            jbc.Dirichlet(u=_inflow), jbc.Neumann(), jbc.Neumann(), jbc.Neumann())))
