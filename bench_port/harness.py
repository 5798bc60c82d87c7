"""One run of one cell: set-up, the replayed window, the traced block,
the check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, per-layer
metric or cell is a file of its own, found by the name in
``BENCHMARK.json``: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (a ``read(run)`` that returns a number or None)
and ``limits/<cell>.json`` (the limit of each number compared).
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from bench_port import inputs as inputs_mod
from bench_port import program, trace, window

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
WARMUP_STEPS = 10
BLOCK_STEPS = 20
FORBIDDEN = ("jax", "jaxlib", "flax", "fluidsolver_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def load_traffic(name: str) -> dict:
    """The mix's parameters, with its ``name``."""
    return dict(load_json(HERE / "traffic" / f"{name}.json"), name=name)


def make_inputs(traffic: dict, config: dict, seed: int, device) -> inputs_mod.Inputs:
    """The mix's initial fields from ``seed``: by ``traffic/<name>.py``'s
    own generator where the mix has one, else by the built-in kinds."""
    generate = inputs_mod.generator(traffic.get("name", ""), HERE / "traffic")
    return generate(traffic, config, seed, device)


def load_limits(cell: str) -> dict:
    return load_json(HERE / "limits" / f"{cell}.json")


def load_reader(metric: str) -> Callable:
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"bench_port.metrics.{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def cell_metrics(spec: dict, cell: str) -> tuple:
    """(end-to-end metrics, per-layer metrics) that ``cell`` reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    layer = [m for m in spec["per_layer"]
             if cell in m.get("workloads", [cell]) and m["moves"] in names]
    return e2e, layer


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, its libraries' or the
    JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


@dataclasses.dataclass
class Run:
    """What a per-layer reader reads."""
    window: window.Window
    trace: Optional[trace.Trace]
    grid: dict
    dtype: str


@dataclasses.dataclass
class Capture:
    """The sampled step of the window's first block: the program's state
    before it and after it, copied into buffers made at set-up (so that
    the step drawn does not change the memory the run holds)."""
    index: int
    before: object
    after: object
    taken: bool = False


def _run_block(sim, steps: int, after_step: Callable[[int], None]) -> None:
    count = [0]

    def callback(_state):
        after_step(count[0])
        count[0] += 1

    sim.run(max_steps=steps, callback=callback)


def measure(cell: dict, config: dict, traffic: dict, seed: int, seconds: float, traced: bool,
            device, t_start: float, cfg_overrides: Optional[dict] = None,
            wrap_step: Optional[Callable] = None, keep_capture: bool = False,
            dtype: Optional[torch.dtype] = None) -> dict:
    """Set-up, window, traced block and check of one run; returns the
    numbers the result line is made of. ``cfg_overrides`` and ``dtype``
    (the state's, if not the configuration's) are for the control;
    ``wrap_step`` (for the harness's own tests) replaces the program's step
    by ``wrap_step(step)``; ``keep_capture`` returns the sampled step's
    states too."""
    dtype = dtype or getattr(torch, config["dtype"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        program.build_kernels()
    inputs = make_inputs(traffic, config, seed, device)
    case = program.make_case(config, cfg_overrides)
    sim = program.make_simulation(case, inputs, dtype, device)
    if wrap_step is not None:
        sim.step = wrap_step(sim.step)
    sample = int(np.random.default_rng([seed, 1]).integers(BLOCK_STEPS))
    # warm-up: every shape of the cell's steps, through the driver
    sim.run(max_steps=WARMUP_STEPS)
    start = sim.state
    # the warm-up's cyclic garbage freed, then every object set-up made is
    # frozen: the collection at each block's start walks only what the
    # window made, in a few milliseconds (a full walk of the heap takes
    # 90-140 ms and varies from run to run)
    gc.collect()
    gc.freeze()
    record = {"lane_budget": program.lane_budget(case.grid) if case.two_phase else None,
              "active_at_start": program.active_cells(start), "sample_step": sample}
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    capture = Capture(sample, program.clone_state(start), program.clone_state(start))
    bad_rows, vol_errors = [], []

    def restore():
        # the port's V-cycle closures are reference cycles that hold a
        # hierarchy each until the cyclic collector runs: collecting at
        # each block's start makes every block allocate and free alike, so
        # the peak does not depend on when the collector happens to run
        # (the restore's time is the window's, and is recorded)
        gc.collect()
        sim.state = program.clone_state(start)
        if sample == 0 and not capture.taken:
            program.copy_state(capture.before, sim.state)

    def observe(block, k):
        obs = sim.observe()
        bad_rows.append(not all(np.isfinite(v) for v in obs.values()))
        if hasattr(sim.state, "vof_vol_error"):
            vol_errors.append(sim.state.vof_vol_error)
        if block == 0 and k == sample - 1:
            program.copy_state(capture.before, sim.state)
        elif block == 0 and k == sample:
            program.copy_state(capture.after, sim.state)
            capture.taken = True
        return {"syncs": program.sync_count(), "p_iter": obs["iter(p)"]}

    win = window.run_window(restore, lambda cb: _run_block(sim, BLOCK_STEPS, cb), seconds,
                            observe)
    if on_card:
        torch.cuda.synchronize()
    record["active_at_end"] = program.active_cells(sim.state)
    # thawed before the traced block: with few objects outside the frozen
    # set the collector walks the profiler's objects often (a pass of
    # 30-100 ms inside the block)
    gc.unfreeze()

    tr = None
    if traced:
        gc.collect()
        sim.state = program.clone_state(start)
        sim.observe()
        with trace.device_trace() as prof:
            t0 = time.perf_counter()
            sim.run(max_steps=BLOCK_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # the trace's events are many small objects and no cycles: the
        # collector would walk them over and over for seconds
        gc.disable()
        try:
            tr = trace.read(prof, wall, BLOCK_STEPS)
        finally:
            gc.enable()
        del prof

    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    # a step fails when its observed values are not finite or its VOF
    # volume error is infinite (a lane overflow)
    if vol_errors:
        inf_err = (~torch.isfinite(torch.stack(vol_errors))).tolist()
        bad_rows = [a or b for a, b in zip(bad_rows, inf_err)]
    failed = sum(bad_rows)
    del sim, start, vol_errors
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    checks = check(config, inputs, capture, device)
    record["check_s"] = time.perf_counter() - t_check
    return dict(window=win, trace=tr, setup_s=setup_s, peak=peak, failed=failed,
                checks=checks, record=record, grid=config["grid"], dtype=config["dtype"],
                capture=capture if keep_capture else None)


def check(config: dict, inputs, capture: Capture, device) -> dict:
    """The numbers compared with the plain reference, in the
    configuration's dtype: the program's initial state built again from
    the same fields, and the sampled step worked out again from the
    program's state before it."""
    from bench_port.reference import build, compare

    dtype = getattr(torch, config["dtype"])
    out = {}
    case = program.make_case(config)
    prog0 = program.state_fields(program.initial_state(case, inputs, dtype, device))
    out["start"] = compare.start_gap(prog0, build.initial_state(config, inputs, dtype, device))
    del prog0
    if not capture.taken:
        return out
    step = build.make_step(config, dtype, device)
    ref = step(build.state_from(compare.cast(program.state_fields(capture.before), dtype)))
    out.update(compare.step_gaps(program.state_fields(capture.after), ref,
                                 config.get("pressure_up_to_constant", False)))
    return out


def verdict(checks: dict, limits: dict) -> tuple:
    """(correct, [[name, value, limit], ...]) over every limit of the cell;
    a number the run could not make reads inf."""
    rows = [[name, checks.get(name, float("inf")), limit] for name, limit in limits.items()]
    return all(v <= lim for _, v, lim in rows), rows


def result_line(cell: dict, spec: dict, m: dict, traced: bool, device) -> dict:
    e2e, layer = cell_metrics(spec, cell["name"])
    win: window.Window = m["window"]
    metrics = {}
    if traced:
        run = Run(window=win, trace=m["trace"], grid=m["grid"], dtype=m["dtype"])
        for spec_m in layer:
            value = load_reader(spec_m["name"])(run)
            if value is not None:
                metrics[spec_m["name"]] = {"value": value, "unit": spec_m["unit"]}
    else:
        values = {"step_ms": win.step_ms(), "step_p90_ms": win.step_quantile_ms(0.9),
                  "peak_mem_gib": m["peak"] / 2 ** 30, "setup_s": m["setup_s"]}
        for spec_m in e2e:
            metrics[spec_m["name"]] = {"value": values[spec_m["name"]], "unit": spec_m["unit"]}
    dev = torch.device(device)
    out_dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": cell["chips"],
               "memory_peak_bytes": m["peak"]}
    line = {"attempted": len(win.steps), "failed": m["failed"], "metrics": metrics,
            "device": out_dev}
    if traced:
        tr = m["trace"]
        out_dev["busy_s"] = tr.busy_s()
        out_dev["window_s"] = tr.wall_s
        line["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    return line
