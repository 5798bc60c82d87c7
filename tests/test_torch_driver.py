"""The port's ``Simulation`` driver and CLI against the JAX package's, on
the CPU in f64, and the host reads it adds.

Observed columns are held to 1e-12 relative to their column's scale
(measured 6.6e-16 at most), with the pressure solves tightened to 1e-11
(as in ``test_torch_twophase.py``). The solver's exit values are not
converged quantities: the residual is held below the tolerance in both
packages and max|div| (a residual too) to 1e-12 of max|U|/dx. Both
packages solve with the same BoxMG hierarchy (the dense coarsest inverse
in f64), so the iteration counts are equal: 13 a step on
``taylor_green``, 31, 31, 29 on ``two_phase_channel``.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu.driver import Simulation as JSimulation
from fluidsolver_tpu.io.monitor_parse import read_monitor_file as jread_monitor_file
from fluidsolver_tpu.utils import diagnostics as jdiag
from fluidsolver_tpu.utils import quadrature as jquad
from fluidsolver_tpu_torch import driver
from fluidsolver_tpu_torch.cases import get_case, list_cases
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.io.monitor_parse import read_monitor_file
from fluidsolver_tpu_torch.io.writer import SaveCadence
from fluidsolver_tpu_torch.utils import diagnostics, profiling, quadrature

torch.set_num_threads(1)
TOL = 1e-12
TIGHT = dict(pressure_tol=1e-11, pressure_tol_intermediate=1e-9)
ROOT = Path(__file__).resolve().parent.parent


def tightened(case):
    case.cfg = dataclasses.replace(case.cfg, **TIGHT)
    return case


def check_columns(got: list, want: list, dx: float) -> None:
    """Per-step observed values (name -> float) of the port against JAX."""
    assert len(got) == len(want)
    for name in want[0]:
        a = np.array([row[name] for row in got])
        b = np.array([row[name] for row in want])
        if name == "iter(p)":
            assert np.array_equal(a, b), (a, b)
        elif name == "res(p)":
            assert max(a.max(), b.max()) <= TIGHT["pressure_tol"], (a, b)
        elif name == "max(div)":
            u_scale = max(np.abs([row["max(U)"] for row in want]).max(), 1.0)
            assert np.abs(a - b).max() <= TOL * u_scale / dx, (a, b)
        else:
            # a volume fraction's scale is 1
            scale = 1.0 if name in ("min(vof)", "max(vof)") else (np.abs(b).max() or 1.0)
            assert np.abs(a - b).max() <= TOL * scale, (name, a, b)


@pytest.mark.parametrize("name,kwargs,run", [
    ("taylor_green", dict(n=16), dict(t_end=0.03)),
    ("two_phase_channel", dict(ny=12), dict(max_steps=3)),
])
def test_driver_against_jax(tmp_path, name, kwargs, run):
    jcase, case = tightened(jget_case(name, **kwargs)), tightened(get_case(name, **kwargs))
    jsim = JSimulation(jcase, output_dir=str(tmp_path / "jax"), writer="vtk")
    sim = driver.Simulation(case, output_dir=str(tmp_path / "port"), writer="vtk",
                            dtype=torch.float64, device="cpu")
    want = [{k: float(jsim._obs_scalar(k)) for k in ("time", "dt", "max(U)", "max(V)", "max(div)",
                                                      "res(p)", "iter(p)")}]
    if case.two_phase:
        want[0].update({k: float(jsim._obs_scalar(k)) for k in ("min(curv)", "max(curv)", "min(vof)",
                                                                 "max(vof)", "int(vof)")})
    got = [dict(sim.observe())]
    jsim.run(callback=lambda s: want.append({k: float(jsim._obs_scalar(k)) for k in want[0]}), **run)
    sim.run(callback=lambda s: got.append(dict(sim.observe())), **run)
    assert sim.n_steps == jsim.n_steps >= 3
    check_columns(got, want, case.grid.dx)

    # the same table layout: the header line, the columns and the rows
    mine = (tmp_path / "port" / "monitor.log").read_text().splitlines()
    theirs = (tmp_path / "jax" / "monitor.log").read_text().splitlines()
    assert mine[:2] == theirs[:2] and len(mine) == len(theirs) == sim.n_steps + 3
    table, jtable = read_monitor_file(str(tmp_path / "port" / "monitor.log")), jread_monitor_file(
        str(tmp_path / "port" / "monitor.log"))
    assert list(table) == list(jtable) and len(table["time"]) == sim.n_steps + 1
    for k, col in table.items():
        np.testing.assert_array_equal(col, jtable[k])
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))


def test_driver_observes_only(tmp_path):
    """N driver steps give the state of N bare step calls bit for bit; a
    driver step costs the bare step's host syncs plus one, plus one more
    when it writes a frame."""
    case = get_case("two_phase_channel", ny=12)
    case.dt_write = 0.025  # a frame every few steps
    sim = driver.Simulation(case, output_dir=str(tmp_path), writer="vtk", dtype=torch.float64, device="cpu")
    n_steps = 6

    step = case.make_step(torch.float64, "cpu")
    bare, bare_syncs, times = sim.state, [], []
    for _ in range(n_steps):
        s0 = sync.count
        bare = step(bare, case.t_end)
        bare_syncs.append(sync.count - s0)
        times.append((float(bare.flow.t), float(bare.flow.dt)))
    cadence = SaveCadence(case.dt_write, case.t_end)
    frames = [int(cadence(t, dt)) for t, dt in times]
    assert 0 < sum(frames) < n_steps

    marks = [sync.count]
    out = sim.run(max_steps=n_steps, callback=lambda s: marks.append(sync.count))
    # the initial frame (one copy of the planes), then each step
    assert np.diff(marks).tolist() == [b + 1 + f + (k == 0) for k, (b, f) in enumerate(zip(bare_syncs, frames))]
    assert len([f for f in os.listdir(tmp_path) if f.endswith(".vtk")]) == 1 + sum(frames)
    for f in dataclasses.fields(out.flow):
        assert torch.equal(getattr(out.flow, f.name), getattr(bare.flow, f.name)), f.name
    for k in ("vf", "vf_old", "curv", "interface_length", "vof_vol_error"):
        assert torch.equal(getattr(out, k), getattr(bare, k)), k


def test_driver_check_nan(tmp_path):
    case = get_case("taylor_green", n=16)
    sim = driver.Simulation(case, output_dir=str(tmp_path), writer="vtk", dtype=torch.float64,
                            device="cpu", check_nan=True)
    sim.run(max_steps=2)
    assert sim.n_steps == 2
    U = sim.state.U.clone()
    U[5, 5] = float("nan")
    sim.state = dataclasses.replace(sim.state, U=U)
    with pytest.raises(FloatingPointError, match="NaN in U"):
        sim.run(max_steps=2)


def test_main_writes_monitor_and_frames(tmp_path, capsys):
    out = tmp_path / "out"
    sim = driver.main(["stationary_drop", "--param", "n=16", "--t-end", "0.25", "--x64", "--device", "cpu",
                       "--writer", "vtk", "--output", str(out)])
    assert sim.device == torch.device("cpu") and sim.state.vf.dtype == torch.float64
    assert "finished: 3 steps" in capsys.readouterr().out
    data = read_monitor_file(str(out / "monitor.log"))
    assert len(data["time"]) == sim.n_steps + 1 == 4
    assert data["time"][-1] == pytest.approx(0.25)
    # dt_write 0.1: the initial frame, t = 0.1, 0.2 and the end
    assert sorted(f for f in os.listdir(out) if f.endswith(".vtk")) == [f"state_{k:06d}.vtk" for k in range(4)]


def test_device_trace_holds_ranges(tmp_path):
    """``--profile``'s trace: a Chrome trace with the named ranges."""
    with profiling.device_trace(str(tmp_path), "cpu"):
        with profiling.annotate("driver.test_range"):
            torch.ones(3).add_(1.0)
    trace = json.loads((tmp_path / profiling.TRACE_FILE).read_text())
    assert "driver.test_range" in {e.get("name") for e in trace["traceEvents"]}


def test_module_help_lists_cases():
    proc = subprocess.run([sys.executable, "-m", "fluidsolver_tpu_torch", "--help"], capture_output=True,
                          text=True, timeout=120, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr
    assert "--device" in proc.stdout and "vof_tgv" in list_cases()
    assert all(name in proc.stdout for name in list_cases())


def test_diagnostics_against_jax():
    rng = np.random.default_rng(4)
    g = make_grid(0.0, 1.5, 12, -0.5, 0.5, 10)
    vf, U, V = rng.random((14, 12)), rng.normal(size=(15, 12)), rng.normal(size=(14, 13))
    t = [torch.as_tensor(a) for a in (vf, U, V)]
    for got, want in ((diagnostics.vof_stats(t[0], 0.7, g.dx, g.dy), jdiag.vof_stats(vf, 0.7, g.dx, g.dy)),
                      (diagnostics.center_of_mass(t[0], g), jdiag.center_of_mass(vf, g)),
                      (diagnostics.avg_phase_velocity(*t), jdiag.avg_phase_velocity(vf, U, V))):
        np.testing.assert_allclose([float(a) for a in got], [float(b) for b in want], rtol=1e-14)
    args = {"eotvos": (1e3, -9.81, 1e-3, 0.072), "galilei": (-9.81, 1e-3, 1e3, 1e-3),
            "weber": (1e3, 0.5, 1e-3, 0.072), "reynolds": (1e3, 0.5, 1e-3, 1e-3),
            "morton": (-9.81, 8.8e-4, 1e3, 0.072), "capillary": (1e-3, 0.5, 0.072), "ohnesorge": (4.0, 25.0)}
    for name, a in args.items():
        assert getattr(diagnostics, name)(*a) == getattr(jdiag, name)(*a), name
    assert diagnostics.weber(1e3, 0.5, 1e-3, 0.0) == np.inf


def test_quadrature_against_jax():
    f1, f2 = (lambda x: np.exp(-x) * np.sin(3 * x)), (lambda x, y: np.cos(x) * y**3 + x * y)
    for n in (1, 5, 16, 64):
        assert quadrature.gauss_legendre(f1, -0.5, 2.0, n) == jquad.gauss_legendre(f1, -0.5, 2.0, n)
        assert (quadrature.gauss_legendre_2d(f2, 0.0, 1.0, -1.0, 2.0, n)
                == jquad.gauss_legendre_2d(f2, 0.0, 1.0, -1.0, 2.0, n))
    x = np.linspace(0.0, 2.0, 21)
    vals = f1(x)
    assert quadrature.midpoint_rule(vals, 0.1) == jquad.midpoint_rule(vals, 0.1)
    assert quadrature.trapezoidal_rule(vals, x) == jquad.trapezoidal_rule(vals, x)
    assert quadrature.simpsons_rule(vals, 0.0, 2.0) == jquad.simpsons_rule(vals, 0.0, 2.0)
    with pytest.raises(ValueError):
        quadrature.simpsons_rule(vals[:-1], 0.0, 2.0)
    with pytest.raises(ValueError):
        quadrature.gauss_legendre(f1, 0.0, 1.0, 65)
