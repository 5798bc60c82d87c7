"""A run with its timed path broken underneath comes out not correct: the
harness run on the CPU at a small size (the look for a card skipped), each
cell's limits as committed. Faults a solver step can have: it returns its
state unchanged; it leaves half of the domain at its input values; it
alters an answer where it is produced. (There is no batch and no exchange
between cards in these cells.)"""

import dataclasses
import time

import pytest

from bench_port import harness

from small import small_config

SEED = 14   # its sampled step is the block's first, so a short window reaches it


def unchanged(step):
    return lambda state, t_end: state


def _first_half_from(out, old):
    """``out`` with the first half of the rows of every field from ``old``."""
    kw = {}
    for f in dataclasses.fields(out):
        a, b = getattr(out, f.name), getattr(old, f.name)
        if dataclasses.is_dataclass(a):
            kw[f.name] = _first_half_from(a, b)
        elif a.dim() == 2:
            a = a.clone()
            a[: a.shape[0] // 2] = b[: a.shape[0] // 2]
            kw[f.name] = a
        else:
            kw[f.name] = a
    return type(out)(**kw)


def half_domain(step):
    return lambda state, t_end: _first_half_from(step(state, t_end), state)


def altered_answer(step):
    """The pressure, which every cell compares, altered at one cell by 1%
    of its largest value."""
    def broken(state, t_end):
        out = step(state, t_end)
        flow = out.flow if hasattr(out, "flow") else out
        p = flow.p.clone()
        p[p.shape[0] // 2, p.shape[1] // 2] += 0.01 * float(p.abs().max())
        flow = dataclasses.replace(flow, p=p)
        return dataclasses.replace(out, flow=flow) if hasattr(out, "flow") else flow
    return broken


def _run(cell_name, wrap=None):
    spec = harness.load_spec()
    cell = {c["name"]: c for c in spec["workloads"]}[cell_name]
    config = small_config(harness.load_config(cell["config"]))
    m = harness.measure(cell, config, harness.load_traffic(cell["traffic"]), SEED, 1.5, False,
                        "cpu", time.perf_counter(), wrap_step=wrap)
    correct, rows = harness.verdict(m["checks"], harness.load_limits(cell["name"]))
    return correct and m["failed"] == 0 and len(m["window"].steps) > 0, rows


CELLS = [c["name"] for c in harness.load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    correct, rows = _run(cell)
    assert correct, rows


@pytest.mark.parametrize("fault", [unchanged, half_domain, altered_answer])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_step_is_not_correct(cell, fault):
    correct, rows = _run(cell, fault)
    assert not correct, rows


@pytest.mark.parametrize("cell_name", CELLS)
def test_the_control_is_not_correct(cell_name):
    """The reference with its state stored one precision below the
    configuration's, in the program's place, fails a limit of the cell (the
    card-sized readings are ``control.py``'s)."""
    from bench_port import control

    spec = harness.load_spec()
    cell = {c["name"]: c for c in spec["workloads"]}[cell_name]
    config = small_config(harness.load_config(cell["config"]))
    m = harness.measure(cell, config, harness.load_traffic(cell["traffic"]), SEED, 1.5, False,
                        "cpu", time.perf_counter(), keep_capture=True)
    fields = harness.make_inputs(harness.load_traffic(cell["traffic"]), config, SEED, "cpu")
    gaps = control.reference_lower(config, m["capture"], "cpu", fields)
    limits = harness.load_limits(cell["name"])
    assert set(gaps) == set(limits)
    correct, rows = harness.verdict(gaps, limits)
    assert not correct, rows


@pytest.mark.card
def test_the_control_at_the_cells_size_on_the_card(card):
    """control.py's program and reference_lower at the channel cell's own
    size, three seeds: the program within its limits, the control outside
    them."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[2]
    out = subprocess.run([sys.executable, "bench_port/control.py", "--workload",
                          "two_phase_channel.one_drop", "--seeds", "31", "32", "33",
                          "--kinds", "program", "reference_lower"],
                         cwd=repo, check=True, capture_output=True, text=True, timeout=3000).stdout
    limits = harness.load_limits("two_phase_channel.one_drop")
    for row in map(json.loads, out.strip().splitlines()):
        correct, _ = harness.verdict(dict({"start": 0.0}, **row["checks"]), limits)
        assert correct == (row["kind"] == "program"), row
