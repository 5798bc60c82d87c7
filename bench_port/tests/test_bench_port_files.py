"""Every file of BENCHMARK.json loads, and a configuration, a traffic mix
and a per-layer metric are added as new files alone."""

import json
import shutil

import pytest
import torch

from bench_port import harness, inputs, window

from small import small_config


def test_every_cell_finds_its_files():
    spec = harness.load_spec()
    assert spec["paths"] == ["bench_port"]
    configs = {c["name"]: c for c in spec["configs"]}
    for cell in spec["workloads"]:
        config = harness.load_config(cell["config"])
        assert config["name"] == cell["config"]
        assert configs[cell["config"]]["reduced"] == config["reduced"]
        traffic = harness.load_traffic(cell["traffic"])
        assert traffic["name"] == cell["traffic"]
        assert "velocity" in traffic or (harness.HERE / "traffic" / f"{cell['traffic']}.py").exists()
        limits = harness.load_limits(cell["name"])
        assert limits and all(v >= 0 for v in limits.values())
        e2e, layer = harness.cell_metrics(spec, cell["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and layer
    for metric in spec["per_layer"]:
        assert callable(harness.load_reader(metric["name"]))


def test_inputs_are_a_function_of_the_seed():
    for name in ("one_drop", "drop_swarm", "re100"):
        traffic = harness.load_traffic(name)
        config = small_config(harness.load_config(
            "lid_cavity" if name == "re100" else "two_phase_channel"), 64)
        a = harness.make_inputs(traffic, config, 2 ** 31 + 7, "cpu")
        b = harness.make_inputs(traffic, config, 2 ** 31 + 7, "cpu")
        c = harness.make_inputs(traffic, config, 2 ** 31 + 8, "cpu")
        assert torch.equal(a.U0, b.U0) and a.drops == b.drops
        if a.vf0 is not None:
            # the drops do not move with the seed (their jitter is 0)
            assert torch.equal(a.vf0, b.vf0) and torch.equal(a.vf0, c.vf0)
            assert float(a.vf0.min()) >= 0.0 and float(a.vf0.max()) <= 1.0
        else:
            assert not torch.equal(a.U0, c.U0)


def test_drop_fractions_hold_the_disc_area():
    config = small_config(harness.load_config("two_phase_channel"), 256)
    traffic = harness.load_traffic("drop_swarm")
    got = inputs.generate(traffic, config, 3, "cpu")
    g = config["grid"]
    cell = (g["x_max"] - g["x_min"]) / g["nx"] * (g["y_max"] - g["y_min"]) / g["ny"]
    area = float(got.vf0.sum()) * cell
    # the 16-point rule on a disc's edge: about 4e-6 of the area at 256 cells
    assert area == pytest.approx(8 * torch.pi * 0.05 ** 2, rel=2e-5)
    centres = torch.tensor(got.drops, dtype=torch.float64)
    d = torch.cdist(centres, centres) + torch.eye(8)
    assert float(d.min()) >= 0.12 - 3e-4
    fixed = torch.tensor(traffic["drops"]["centers"], dtype=torch.float64)
    assert float((centres - fixed).abs().max()) <= traffic["drops"]["jitter"]


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path, monkeypatch):
    """A later change adds files and BENCHMARK.json entries; no file of the
    folder is edited."""
    here = tmp_path / "bench_port"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_spec()
    config = small_config(harness.load_config("lid_cavity"))
    config["name"] = "lid_cavity_tiny"
    (here / "configs" / "lid_cavity_tiny.json").write_text(json.dumps(config))
    (here / "traffic" / "still.json").write_text(json.dumps(
        {"velocity": {"kind": "stream_perturbation", "modes": 2, "peak": 1e-3}}))
    (here / "limits" / "lid_cavity_tiny.still.json").write_text(json.dumps(
        {"start": 0.0, "U": 0.0, "V": 0.0, "p": 0.0}))
    (here / "metrics" / "steps_in_window.py").write_text(
        "def read(run):\n    return float(len(run.window.steps))\n")
    spec["workloads"].append({"name": "lid_cavity_tiny.still", "config": "lid_cavity_tiny",
                              "traffic": "still", "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "steps_in_window", "unit": "steps", "better": "higher",
                              "source": "host_clock", "layer": "driver and step",
                              "moves": "step_ms"})
    before = {p: p.read_bytes() for p in harness.HERE.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "load_spec", lambda: spec)
    cell = spec["workloads"][-1]
    m = harness.measure(cell, harness.load_config(cell["config"]),
                        harness.load_traffic(cell["traffic"]), 14, 2.0, False, "cpu", 0.0)
    correct, rows = harness.verdict(m["checks"], harness.load_limits(cell["name"]))
    assert correct and len(rows) == 4
    _, layer = harness.cell_metrics(spec, cell["name"])
    assert "steps_in_window" in {x["name"] for x in layer}
    run = harness.Run(window=m["window"], trace=None, grid=m["grid"], dtype="float32")
    assert harness.load_reader("steps_in_window")(run) == len(m["window"].steps) > 0
    assert isinstance(m["window"], window.Window)
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_drop_fractions_follow_the_ports_rule():
    """On the cells it averages, the generator's rule is the port's
    (``vof.init.liquid_fraction_from_indicator``) to rounding."""
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator

    config = small_config(harness.load_config("two_phase_channel"), 64)
    got = inputs.generate(harness.load_traffic("one_drop"), config, 11, "cpu")
    (cx, cy), = got.drops
    grid = get_case("two_phase_channel", ny=64).grid
    want = liquid_fraction_from_indicator(
        lambda x, y: (x - cx) ** 2 + (y - cy) ** 2 <= 0.05 ** 2, grid)
    assert float((got.vf0 - torch.as_tensor(want)).abs().max()) < 1e-14


BUBBLE_GENERATOR = """
import torch

from bench_port import inputs


def generate(traffic, config, seed, device):
    # a gas bubble in liquid: the inverse of the built-in liquid discs
    g = config["grid"]
    spec = traffic["bubble"]
    liquid = 1.0 - inputs.disc_fractions([tuple(spec["center"])], spec["radius"], g, device)
    U0 = torch.zeros((g["nx"] + 3, g["ny"] + 2), dtype=torch.float64, device=device)
    V0 = torch.zeros((g["nx"] + 2, g["ny"] + 3), dtype=torch.float64, device=device)
    return inputs.Inputs(vf0=liquid, U0=U0, V0=V0, drops=[spec["center"]])
"""


def test_a_new_mix_brings_its_own_generator(tmp_path, monkeypatch):
    """A mix whose fields the built-in kinds cannot make (a gas bubble in
    liquid) adds ``traffic/<name>.json`` and its own ``traffic/<name>.py``
    beside it; the harness runs it, and no file of the folder is edited."""
    here = tmp_path / "bench_port"
    shutil.copytree(harness.HERE, here, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.load_spec()
    config = small_config(harness.load_config("two_phase_channel"))
    config["name"] = "two_phase_channel_tiny"
    (here / "configs" / "two_phase_channel_tiny.json").write_text(json.dumps(config))
    (here / "traffic" / "bubble.json").write_text(json.dumps(
        {"why": "a test", "bubble": {"radius": 0.05, "center": [0.3, 0.2]}}))
    (here / "traffic" / "bubble.py").write_text(BUBBLE_GENERATOR)
    (here / "limits" / "two_phase_channel_tiny.bubble.json").write_text(json.dumps(
        {"start": 0.0, "vf": 0.0, "U": 0.0, "V": 0.0, "p": 0.0}))
    spec["workloads"].append({"name": "two_phase_channel_tiny.bubble",
                              "config": "two_phase_channel_tiny", "traffic": "bubble",
                              "chips": 1, "why": "a test"})
    before = {p: p.read_bytes() for p in harness.HERE.rglob("*") if p.is_file()
              and "__pycache__" not in p.parts}
    monkeypatch.setattr(harness, "HERE", here)
    monkeypatch.setattr(harness, "load_spec", lambda: spec)
    cell = spec["workloads"][-1]
    traffic = harness.load_traffic(cell["traffic"])
    fields = harness.make_inputs(traffic, harness.load_config(cell["config"]), 5, "cpu")
    # liquid all round, gas in the bubble: the mix's own generator ran
    assert float(fields.vf0.max()) == 1.0 and float(fields.vf0.min()) < 0.5
    assert float(fields.vf0.mean()) > 0.9
    m = harness.measure(cell, harness.load_config(cell["config"]), traffic, 14, 2.0, False,
                        "cpu", 0.0)
    correct, rows = harness.verdict(m["checks"], harness.load_limits(cell["name"]))
    assert correct and len(rows) == 5 and m["failed"] == 0 and m["window"].steps
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.parametrize("side, want", [
    ({"type": "Neumann", "clipped": True}, "Neumann(clipped=True)"),
    ({"type": "Dirichlet", "u": 1.0}, "Dirichlet(u=1.0, v=0.0)"),
    ({"type": "Symmetry"}, "Symmetry()"),
    ({"type": "Periodic"}, "Periodic()")])
def test_the_reference_takes_every_boundary_condition_by_name(side, want):
    """A configuration names its sides' conditions; the reference builds
    each by the name and fields in the file."""
    from bench_port.reference import build

    assert repr(build._side(side, 1.0)) == want
