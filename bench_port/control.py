"""The readings that the limits of ``limits/<cell>.json`` are set from.

    python3 bench_port/control.py --workload <cell> --seeds 11 12 13 [--seconds 4]
        [--kinds program program_lower reference_lower]

runs, in one process on the card and at the cell's own size, a short
window of each seed and prints the numbers compared for each kind:

- ``program``: the port as the cell runs it (the lower readings);
- ``program_lower``: the port's own path one precision below the
  configuration's: a float32 state for a float64 configuration, the
  bfloat16 preconditioner (``pressure_precond_dtype``) for a float32 one;
- ``reference_lower``: the reference in the program's place, its state
  stored one precision below (float32 for float64, bfloat16 for float32:
  the sampled step's input and output rounded to it), judged against the
  reference in the configuration's dtype from the same input.

The benchmark's own runs never run this. One JSON line per (kind, seed)
on standard output.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

LOWER = {"float64": "float32", "float32": "bfloat16"}


def _rounded(fields: dict, low, dtype) -> dict:
    """Every floating-point tensor stored in ``low`` and read back as ``dtype``."""
    out = {}
    for k, v in fields.items():
        if isinstance(v, dict):
            out[k] = _rounded(v, low, dtype)
        elif v.is_floating_point():
            out[k] = v.to(low).to(dtype)
        else:
            out[k] = v
    return out


def reference_lower(config: dict, capture, device, inputs=None) -> dict:
    """The gaps of the reference run on states stored one precision below
    the configuration's, against the reference in its dtype, from the
    program's state before the sampled step; with ``inputs``, also the
    initial state so stored against the reference's own."""
    import torch

    from bench_port import program
    from bench_port.reference import build, compare

    dtype = getattr(torch, config["dtype"])
    low = getattr(torch, LOWER[config["dtype"]])
    out = {}
    if inputs is not None:
        start = build.initial_state(config, inputs, dtype, device)
        out["start"] = compare.start_gap(_rounded(compare.as_fields(start), low, dtype), start)
        del start
    before = compare.cast(program.state_fields(capture.before), dtype)
    step = build.make_step(config, dtype, device)
    exact = step(build.state_from(before))
    stored = step(build.state_from(_rounded(before, low, dtype)))
    out.update(compare.step_gaps(_rounded(compare.as_fields(stored), low, dtype), exact,
                                 config.get("pressure_up_to_constant", False)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--kinds", nargs="+", default=["program", "program_lower", "reference_lower"])
    args = ap.parse_args(argv)

    import torch

    from bench_port import harness

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    spec = harness.load_spec()
    cell = {c["name"]: c for c in spec["workloads"]}[args.workload]
    config = harness.load_config(cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    lower = {"dtype": torch.float32} if config["dtype"] == "float64" else {
        "cfg_overrides": {"pressure_precond_dtype": "bfloat16"}}
    for seed in args.seeds:
        runs = [("program", {})] if {"program", "reference_lower"} & set(args.kinds) else []
        if "program_lower" in args.kinds:
            runs.append(("program_lower", lower))
        for kind, options in runs:
            t0 = time.perf_counter()
            m = harness.measure(cell, config, traffic, seed, args.seconds, False, device, t0,
                                keep_capture=True, **options)
            rows = []
            if kind in args.kinds:
                rows.append({"kind": kind, "seed": seed, "checks": m["checks"],
                             "steps": len(m["window"].steps),
                             "p_iter_per_step": m["window"].mean("p_iter"), "failed": m["failed"],
                             "seconds": time.perf_counter() - t0, "record": m["record"]})
            if kind == "program" and "reference_lower" in args.kinds and m["capture"].taken:
                t1 = time.perf_counter()
                fields = harness.make_inputs(traffic, config, seed, device)
                rows.append({"kind": "reference_lower", "seed": seed,
                             "checks": reference_lower(config, m["capture"], device, fields),
                             "seconds": time.perf_counter() - t1})
            del m
            for row in rows:
                print(json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
