"""Run one cell of the benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is one JSON
object (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
with ``--trace 1`` also ``breakdown``, and last ``checks``: each number
compared with its limit); the last lines of standard error repeat the
numbers compared. Without a CUDA card, or with fewer cards than the cell
asks for, it exits with 2 and prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
# every build and kernel cache inside the checkout, at fixed paths
CACHE = CHECKOUT / ".bench_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ.setdefault("USE_FLAX", "0")
sys.path.insert(0, str(CHECKOUT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_port import harness

    spec = harness.load_spec()
    cells = {c["name"]: c for c in spec["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}; cells: {sorted(cells)}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    config = harness.load_config(cell["config"])
    traffic = harness.load_traffic(cell["traffic"])
    limits = harness.load_limits(cell["name"])
    device = torch.device("cuda", 0)

    m = harness.measure(cell, config, traffic, args.seed, args.seconds, bool(args.trace),
                        device, T_START)
    line = harness.result_line(cell, spec, m, bool(args.trace), device)
    correct, rows = harness.verdict(m["checks"], limits)
    correct = correct and line["attempted"] > 0 and line["failed"] == 0

    found = harness.forbidden_modules()
    if found:
        print(f"loaded modules that the run must not load: {found}", file=sys.stderr)
        return 3
    win = m["window"]
    times = [s.seconds for s in win.steps]
    record = dict(m["record"], steps=len(times), p_iter_per_step=win.mean("p_iter"),
                  syncs_per_step=win.per_step("syncs"), restore_ms=win.restore_ms(),
                  block_step_ms=win.block_step_ms(),
                  step_ms_quartiles=[1e3 * q for q in statistics.quantiles(times, n=4)]
                  if len(times) > 1 else None)
    print(json.dumps({"record": record}), file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    # a number that is not finite prints as its name: JSON has no inf
    checks = {name: {"value": value if math.isfinite(value) else repr(value), "limit": limit}
              for name, value, limit in rows}
    result = {"correct": correct, **line, "checks": checks}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
