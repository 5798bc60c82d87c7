"""The port's I/O layer against the JAX package's, on the CPU in f64.

Monitor tables and VTK files are byte-identical for the same values; the
XDMF writers store the same datasets and XML; the save cadence makes the
same decisions; npy dumps and checkpoints move across the two packages in
both directions. Checkpoints resumed across packages are held to 1e-12
relative (the bound of ``test_torch_twophase.py``) with the pressure
solves tightened to 1e-11, as there, and the same PCG iteration count:
both packages solve with the same BoxMG hierarchy (the dense coarsest
inverse in f64).
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from fluidsolver_tpu.cases import get_case as jget_case
from fluidsolver_tpu.core.grid import make_grid as jmake_grid
from fluidsolver_tpu.io import checkpoint as jcheckpoint
from fluidsolver_tpu.io.monitor import Monitor as JMonitor
from fluidsolver_tpu.io.monitor_parse import read_monitor_file as jread_monitor_file
from fluidsolver_tpu.io.npy import load_state_npy as jload_state_npy
from fluidsolver_tpu.io.npy import save_state_npy as jsave_state_npy
from fluidsolver_tpu.io.vtk import VTKWriter as JVTKWriter
from fluidsolver_tpu.io.vtk import save_interface_vtk as jsave_interface_vtk
from fluidsolver_tpu.io.writer import SaveCadence as JSaveCadence
from fluidsolver_tpu.io.xdmf import XDMFWriter as JXDMFWriter
from fluidsolver_tpu.vof.plic import Plic as JPlic
from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core.grid import make_grid
from fluidsolver_tpu_torch.io import checkpoint
from fluidsolver_tpu_torch.io.monitor import Monitor
from fluidsolver_tpu_torch.io.monitor_parse import read_monitor_file
from fluidsolver_tpu_torch.io.npy import load_state_npy, save_state_npy
from fluidsolver_tpu_torch.io.vtk import VTKWriter, save_interface_vtk
from fluidsolver_tpu_torch.io.writer import SaveCadence, make_data_writer
from fluidsolver_tpu_torch.vof import plic
from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator

torch.set_num_threads(1)
TOL = 1e-12


def leaves(state) -> dict:
    """name -> numpy array of every field of a state of either package."""
    out = {}
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        if dataclasses.is_dataclass(v):
            out.update({f"{f.name}.{k}": a for k, a in leaves(v).items()})
        else:
            out[f.name] = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    return out


def max_rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / (np.abs(want).max() or 1.0))


def test_monitor_byte_identical(tmp_path):
    rng = np.random.default_rng(11)
    rows = [(float(rng.normal() * 10.0 ** rng.integers(-12, 12)), int(rng.integers(0, 10**6)),
             float(-rng.random()), float(rng.integers(-3, 3))) for _ in range(6)]
    rows.append((0.0, 0, -0.0, float("inf")))
    names = ("time", "iter(p)", "a_rather_long_column_name", "loss(vof)")
    for path, cls in ((tmp_path / "port.log", Monitor), (tmp_path / "jax.log", JMonitor)):
        cur = {}
        with cls(str(path)) as mon:
            for k, name in enumerate(names):
                mon.add_variable(lambda k=k: cur["row"][k], name)
            for row in rows:
                cur["row"] = row
                mon.write()
    port = (tmp_path / "port.log").read_bytes()
    assert port == (tmp_path / "jax.log").read_bytes()
    mine, theirs = read_monitor_file(str(tmp_path / "port.log")), jread_monitor_file(str(tmp_path / "port.log"))
    assert list(mine) == list(theirs) == list(names)
    for name in names:
        np.testing.assert_array_equal(mine[name], theirs[name])


def vtk_fields(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape) for _ in range(3)]


def test_vtk_byte_identical(tmp_path):
    args = (0.0, 2.0, 8, -1.0, 1.5, 6)
    p, u, v = vtk_fields((10, 8), 5)
    files = {}
    for tag, writer in (("port", VTKWriter(str(tmp_path / "port"), make_grid(*args))),
                        ("jax", JVTKWriter(str(tmp_path / "jax"), jmake_grid(*args)))):
        writer.add_scalar("pressure", lambda: p)
        writer.add_scalar("VOF", lambda: p.astype(np.float32))
        writer.add_vector("velocity", lambda: u, lambda: v)
        files[tag] = [writer.write(0.25), writer.write(1.0 / 3.0)]
    for mine, theirs in zip(files["port"], files["jax"]):
        assert os.path.basename(mine) == os.path.basename(theirs)
        assert open(mine, "rb").read() == open(theirs, "rb").read()


def test_interface_vtk_byte_identical(tmp_path):
    """save_interface_vtk on one reconstruction (the port's ELVIRA of a
    drop, given to both packages) writes the same bytes."""
    g = make_grid(0.0, 1.0, 16, 0.0, 1.0, 16)
    vf = torch.as_tensor(liquid_fraction_from_indicator(
        lambda x, y: (x - 0.45) ** 2 + (y - 0.55) ** 2 <= 0.3**2, g))
    rec = plic.elvira(vf, g.dx, g.dy)
    jrec = JPlic(nx=rec.nx.numpy(), ny=rec.ny.numpy(), d=rec.d.numpy(), valid=rec.valid.numpy())
    save_interface_vtk(str(tmp_path / "port.vtk"), rec, g)
    jsave_interface_vtk(str(tmp_path / "jax.vtk"), jrec, jmake_grid(0.0, 1.0, 16, 0.0, 1.0, 16))
    raw = (tmp_path / "port.vtk").read_bytes()
    assert raw == (tmp_path / "jax.vtk").read_bytes()
    assert f"POINTS {2 * int(rec.valid.sum())} double".encode() in raw


def test_xdmf_matches_jax(tmp_path):
    h5py = pytest.importorskip("h5py")
    args = (0.0, 1.0, 8, 0.0, 1.0, 6)
    p, u, v = vtk_fields((10, 8), 9)
    for tag, make in (("port", lambda d: make_data_writer(d, make_grid(*args), prefer="xdmf")),
                      ("jax", lambda d: JXDMFWriter(d, jmake_grid(*args)))):
        w = make(str(tmp_path / tag))
        w.add_scalar("pressure", lambda: p)
        w.add_vector("velocity", lambda: u, lambda: v)
        w.write(0.0)
        w.write(0.1)
        w.close()
    assert (tmp_path / "port" / "data.xdmf").read_text() == (tmp_path / "jax" / "data.xdmf").read_text()

    def contents(path):
        out = {}
        with h5py.File(path, "r") as f:
            f.visititems(lambda name, obj: out.__setitem__(
                name, (obj[()], obj.dtype, obj.shape) if isinstance(obj, h5py.Dataset) else dict(obj.attrs)))
        return out

    mine, theirs = contents(tmp_path / "port" / "data.h5"), contents(tmp_path / "jax" / "data.h5")
    assert sorted(mine) == sorted(theirs)
    assert mine["step_000000/pressure"][2] == (6, 8)
    for name, val in mine.items():
        if isinstance(val, dict):
            assert val == theirs[name], name
        else:
            np.testing.assert_array_equal(val[0], theirs[name][0])
            assert val[1:] == theirs[name][1:], name


def test_save_cadence_matches_jax():
    rng = np.random.default_rng(3)
    for dt_write, t_end, dt in ((0.1, 1.0, 0.02), (0.05, 0.3, 0.0137), (1e-2, 2.0, 3e-3)):
        mine, theirs = SaveCadence(dt_write, t_end), JSaveCadence(dt_write, t_end)
        t, got, want = 0.0, [], []
        while t < t_end + dt:
            step = min(dt * (0.5 + rng.random()), t_end - t) if t < t_end else dt
            t += step
            got.append(mine(t, step))
            want.append(theirs(t, step))
        assert got == want and sum(got) >= 3


def test_vtk_reader_reads_port(tmp_path):
    """python/vtk_reader.py parses the port's VTK output exactly."""
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "python"))
    from vtk_reader import last_vtk_file, read_structured_grid

    g = make_grid(0.0, 2.0, 8, 0.0, 1.0, 6)
    p, u, v = vtk_fields((10, 8), 7)
    w = VTKWriter(str(tmp_path), g)
    w.add_scalar("pressure", lambda: torch.as_tensor(p))
    w.add_vector("velocity", lambda: u, lambda: v)
    w.write(0.25)
    w.write(0.75)
    d = read_structured_grid(last_vtk_file(str(tmp_path)))
    assert d["time"] == 0.75
    np.testing.assert_allclose(d["x"], g.xm[1:-1])
    np.testing.assert_allclose(d["y"], g.ym[1:-1])
    np.testing.assert_array_equal(d["scalars"]["pressure"], p[1:-1, 1:-1])
    np.testing.assert_array_equal(d["vectors"]["velocity"][..., 0], u[1:-1, 1:-1])
    np.testing.assert_array_equal(d["vectors"]["velocity"][..., 1], v[1:-1, 1:-1])


def seeded_fields(state, seed: int) -> dict:
    """name -> a random array of each field's shape and dtype (numpy)."""
    rng = np.random.default_rng(seed)
    return {k: (rng.integers(0, 100, size=a.shape) if a.dtype.kind == "i" else rng.normal(size=a.shape))
            .astype(a.dtype) for k, a in leaves(state).items()}


def with_fields(state, values: dict, convert):
    def rebuild(obj, prefix=""):
        kw = {}
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            key = f"{prefix}{f.name}"
            kw[f.name] = rebuild(v, key + ".") if dataclasses.is_dataclass(v) else convert(values[key])
        return dataclasses.replace(obj, **kw)

    return rebuild(state)


def test_npy_dump_across_packages(tmp_path):
    jcase, case = jget_case("stationary_drop", n=16), get_case("stationary_drop", n=16)
    jstate = with_fields(jcase.make_state(np.float64), seeded_fields(jcase.make_state(np.float64), 1),
                         np.asarray)
    jsave_state_npy(str(tmp_path / "jax"), jstate, jcase.grid)
    template = case.make_state(torch.float64, "cpu")
    got = load_state_npy(str(tmp_path / "jax"), template)
    for k, a in leaves(jstate).items():
        np.testing.assert_array_equal(leaves(got)[k], a, err_msg=k)
    assert got.flow.p_iter.dtype == torch.int32 and got.flow.t.shape == ()
    f32 = load_state_npy(str(tmp_path / "jax"), case.make_state(torch.float32, "cpu"))
    assert f32.vf.dtype == torch.float32 and torch.equal(f32.vf, got.vf.float())

    state = with_fields(template, seeded_fields(template, 2), torch.as_tensor)
    save_state_npy(str(tmp_path / "port"), state, case.grid)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(os.listdir(tmp_path / "jax"))
    back = jload_state_npy(str(tmp_path / "port"), jcase.make_state(np.float64))
    for k, a in leaves(state).items():
        np.testing.assert_array_equal(np.asarray(leaves(back)[k]), a, err_msg=k)
    for name in ("x", "y", "xm", "ym"):
        np.testing.assert_array_equal(np.load(tmp_path / "port" / f"{name}.npy"),
                                      np.load(tmp_path / "jax" / f"{name}.npy"))


def drop_cases():
    kw = dict(pressure_tol=1e-11, pressure_max_iter=200)
    jcase, case = jget_case("stationary_drop", n=16), get_case("stationary_drop", n=16)
    jcase.cfg = dataclasses.replace(jcase.cfg, **kw)
    case.cfg = dataclasses.replace(case.cfg, **kw)
    return jcase, case


def assert_states_close(got, want):
    """Every field to TOL, except the solver's exit values: the last
    residual (below the tolerance in both), the iteration count (equal)
    and the VOF volume error (below 1e-12 in both)."""
    got, want = leaves(got), leaves(want)
    for k, a in got.items():
        if k == "flow.p_res":
            assert max(float(a), float(want[k])) <= 1e-11
        elif k == "flow.p_iter":
            assert int(a) == int(want[k]), (int(a), int(want[k]))
        elif k == "vof_vol_error":
            assert max(float(a), float(want[k])) < 1e-12
        else:
            assert max_rel(a, want[k]) <= TOL, (k, max_rel(a, want[k]))


def test_checkpoint_across_packages(tmp_path):
    """3 steps in one package, checkpoint, restore in the other and step
    twice: the same as 2 more steps where the checkpoint was written. Both
    directions."""
    jcase, case = drop_cases()
    jstep, step = jcase.make_step(), case.make_step(torch.float64, "cpu")
    jstate, state = jcase.make_state(np.float64), case.make_state(torch.float64, "cpu")
    for _ in range(3):
        jstate = jstep(jstate, 1e9)
        state = step(state, 1e9)
    jcheckpoint.save(str(tmp_path / "jax.npz"), jstate)
    checkpoint.save(str(tmp_path / "port.npz"), state)

    restored = checkpoint.restore(str(tmp_path / "jax.npz"), case.make_state(torch.float64, "cpu"))
    for k, a in leaves(jstate).items():
        np.testing.assert_array_equal(leaves(restored)[k], a, err_msg=k)
    jrestored = jcheckpoint.restore(str(tmp_path / "port.npz"), jcase.make_state(np.float64))
    for k, a in leaves(state).items():
        np.testing.assert_array_equal(np.asarray(leaves(jrestored)[k]), a, err_msg=k)

    jref, ref = jstate, state
    for _ in range(2):
        restored, jref = step(restored, 1e9), jstep(jref, 1e9)
        jrestored, ref = jstep(jrestored, 1e9), step(ref, 1e9)
    assert_states_close(restored, jref)
    assert_states_close(ref, jrestored)


def test_checkpoint_resume_bitwise(tmp_path):
    """The port's own save/restore resumes bit for bit, and a checkpoint
    restores into a template's dtype and refuses another structure."""
    case = get_case("stationary_drop", n=16)
    step = case.make_step(torch.float64, "cpu")
    state = case.make_state(torch.float64, "cpu")
    for _ in range(3):
        state = step(state, 1e9)
    checkpoint.save(str(tmp_path / "ck.npz"), state)
    ref = state
    for _ in range(2):
        ref = step(ref, 1e9)
    out = checkpoint.restore(str(tmp_path / "ck.npz"), case.make_state(torch.float64, "cpu"))
    for _ in range(2):
        out = step(out, 1e9)
    for k, a in leaves(out).items():
        np.testing.assert_array_equal(a, leaves(ref)[k], err_msg=k)
    f32 = checkpoint.restore(str(tmp_path / "ck.npz"), case.make_state(torch.float32, "cpu"))
    assert f32.flow.U.dtype == torch.float32 and f32.flow.p_iter.dtype == torch.int32
    with pytest.raises(ValueError):
        checkpoint.restore(str(tmp_path / "ck.npz"), case.make_state(torch.float64, "cpu").flow)
