"""The profiler spans of the port's steps (``utils.profiling.annotate``) on
the CPU: one two-phase step (two_phase_channel, ny = 12, with two
subiterations) and one single-phase step (lid_driven, n = 16) under
``torch.profiler``.

Every stage span appears, the pressure layer's spans nest inside
``twophase.pressure``, no two stage spans overlap, and every operator of
a step runs inside a stage span except the four the steps name: the
``dt > 0`` test and its read, the zero warm start and ``t + dt``. With
no profiler running, no range is opened at all.
"""

import dataclasses
import json
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from fluidsolver_tpu_torch.cases import get_case
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.poisson import boxmg, cg
from fluidsolver_tpu_torch.poisson.linsys import assemble_pressure_operator
from fluidsolver_tpu_torch.utils import profiling

torch.set_num_threads(1)
STAGES = ("twophase.dt", "twophase.vof", "twophase.momentum", "twophase.rhs", "twophase.pressure",
          "twophase.projection")
# the top-level operators outside every stage, in order: dt > 0, its read
# (inside twophase.sync), the subiterations' zero warm start, t + dt
OUTSIDE = ["aten::gt", "aten::item", "aten::zeros_like", "aten::add"]
SMOOTH = re.compile(r"pcg\.smooth\.(restrict|correct|coarse)\.(\d+)x(\d+)$")
CASES = {"two_phase": ("two_phase_channel", dict(ny=12)), "single_phase": ("lid_driven", dict(n=16))}


def small_case(name, kwargs):
    # two subiterations: every span a subiteration opens, at less CPU time
    case = get_case(name, **kwargs)
    case.cfg = dataclasses.replace(case.cfg, num_subiter=2)
    return case


def _inside(e, spans):
    return any(s[1] <= e[1] and e[2] <= s[2] for s in spans)


def traced_step(name, kwargs, log_dir):
    """One step of the case in f64 in ``profiling.device_trace`` on the CPU:
    the trace's events (name, start, end) in start order, the case, the
    state after it and the host reads it made."""
    case = small_case(name, kwargs)
    step = case.make_step(torch.float64, "cpu")
    state = case.make_state(torch.float64, "cpu")
    with profiling.device_trace(str(log_dir), "cpu"):
        s0 = sync.count
        state = step(state, case.t_end)
        syncs = sync.count - s0
    trace = json.loads((log_dir / profiling.TRACE_FILE).read_text())
    events = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in trace["traceEvents"]
                     if e.get("cat") in ("cpu_op", "user_annotation")), key=lambda e: (e[1], -e[2]))
    return events, case, state, syncs


@pytest.fixture(scope="module", params=sorted(CASES))
def traced(request, tmp_path_factory):
    return (request.param,) + traced_step(*CASES[request.param], tmp_path_factory.mktemp(request.param))


def test_every_span_appears_and_nests(traced):
    kind, events, case, state, syncs = traced
    by = {}
    for e in events:
        key = "pcg.smooth" if SMOOTH.match(e[0]) else e[0]
        by.setdefault(key, []).append(e)
    sub = case.cfg.num_subiter
    want = {"twophase.dt": 1, "twophase.momentum": sub, "twophase.rhs": sub,
            "twophase.pressure": sub, "twophase.projection": sub, "pcg.solve": sub,
            "twophase.vof": 1 if kind == "two_phase" else 0,
            # the single-phase step builds its hierarchy once, in make_step
            "pcg.hierarchy": sub if kind == "two_phase" else 0,
            "pcg.guards": int(state.flow.p_iter if kind == "two_phase" else state.p_iter),
            "twophase.sync": syncs}
    assert {k: len(by.get(k, [])) for k in want} == want
    for k in ("pcg.solve", "pcg.hierarchy"):
        assert all(_inside(e, by["twophase.pressure"]) for e in by.get(k, []))
    for k in ("pcg.guards", "pcg.smooth"):
        assert by[k] and all(_inside(e, by["pcg.solve"]) for e in by[k])
    # a solve holds no hierarchy build
    assert not any(_inside(h, by["pcg.solve"]) for h in by.get("pcg.hierarchy", []))
    # the first read is dt > 0, outside every stage; the others are the
    # iterations' exit tests, inside the solves
    assert not _inside(by["twophase.sync"][0], [e for k in STAGES for e in by.get(k, [])])
    assert all(_inside(e, by["pcg.solve"]) for e in by["twophase.sync"][1:])
    stages = sorted((e for k in STAGES for e in by.get(k, [])), key=lambda e: e[1])
    assert all(a[2] <= b[1] for a, b in zip(stages, stages[1:])), "stage spans overlap"
    # each smoothing span names the shape of its level: the pressure box
    # (nx + 2) x (ny + 2) and the levels below it, each half the one above
    shapes = {(int(m.group(2)), int(m.group(3))) for m in map(SMOOTH.match, (e[0] for e in by["pcg.smooth"]))}
    chain = [(case.grid.nx + 2, case.grid.ny + 2)]
    while len(chain) < len(shapes):
        chain.append(((chain[-1][0] + 1) // 2, (chain[-1][1] + 1) // 2))
    assert shapes == set(chain)
    forms = {SMOOTH.match(e[0]).group(1) for e in by["pcg.smooth"]}
    assert forms == {"restrict", "correct"}


def test_every_operator_runs_inside_a_stage(traced):
    _, events, _, _, _ = traced
    stages = [e for e in events if e[0] in STAGES]
    top, reach = [], float("-inf")
    for e in events:   # in start order, an operator before those it calls
        if e[0].startswith("aten::") and e[1] >= reach:
            top.append(e)
            reach = e[2]
    assert [e[0] for e in top if not _inside(e, stages)] == OUTSIDE


def test_host_reads_are_counted_as_before(traced):
    kind, _, case, state, syncs = traced
    p_iter = int(state.flow.p_iter if kind == "two_phase" else state.p_iter)
    assert syncs == 1 + p_iter + case.cfg.num_subiter


def test_the_coarse_sweeps_name_their_level():
    """A coarsest level that is neither a tail nor small enough for the
    dense inverse (130 x 4 points) is swept in pairs, each its own span."""
    rho_u = torch.ones(261, 8, dtype=torch.float64)
    rho_v = torch.ones(260, 9, dtype=torch.float64)
    op = assemble_pressure_operator(rho_u, rho_v, 0.1, 0.1, None)
    levels = boxmg.build_hierarchy(op)
    assert levels[-1].tr is None and levels[-1].coarse_inv is None
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        boxmg.v_cycle(levels, torch.ones(op.aC.shape, dtype=torch.float64))
    names = [e.name for e in prof.events() if e.name.startswith("pcg.smooth.")]
    coarse = "x".join(map(str, levels[-1].op.aC.shape))
    fine = "x".join(map(str, op.aC.shape))
    assert names.count(f"pcg.smooth.coarse.{coarse}") == boxmg.COARSE_SWEEPS // 2
    assert f"pcg.smooth.restrict.{fine}" in names and f"pcg.smooth.correct.{fine}" in names


@pytest.mark.parametrize("kind", sorted(CASES))
def test_no_range_is_opened_without_a_profiler(kind, monkeypatch):
    def refuse(name):
        raise AssertionError(f"range {name} opened with no profiler running")

    monkeypatch.setattr(profiling, "record_function", refuse)
    case = small_case(*CASES[kind])
    state = case.make_step(torch.float64, "cpu")(case.make_state(torch.float64, "cpu"), case.t_end)
    assert state is not None and not torch.autograd._profiler_enabled()
    assert cg.build_precond_levels(assemble_pressure_operator(
        torch.ones(19, 18, dtype=torch.float64), torch.ones(18, 19, dtype=torch.float64), 0.1, 0.1, None),
        "boxmg") is not None
