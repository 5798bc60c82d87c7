"""The two-phase bench step of one checkout of the port, timed on the card.

    python3 tools/torch_step_times.py [--checkout DIR] [--steps N] [--mg]

Imports the port and chip_smoke.py from DIR (default: this checkout),
builds its kernels and drives N steps (default 20) of chip_smoke.py's bench
configuration (1024^2, f32, PCG + BoxMG; with --mg on "mg") through its
drive_bench, which prints ms/step by CUDA events, p_iter and the host syncs
per step. Run it for two checkouts in turns (A, B, B, A), each in its own
process, to compare their step times on one card. It needs one CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkout", default=str(Path(__file__).resolve().parent.parent),
                    help="the checkout whose port and chip_smoke.py to run")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--mg", action="store_true", help='run the "mg" preconditioner instead of BoxMG')
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.checkout).resolve()))
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import _kernels

    if not torch.cuda.is_available():
        print("torch_step_times: no CUDA device", file=sys.stderr)
        return 1
    print(args.checkout, torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _kernels.build()
    _kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    g, cfg = chip_smoke.bench_case()
    if args.mg:
        cfg = dataclasses.replace(cfg, pressure_solver="mg")
    chip_smoke.drive_bench(torch.device("cuda", 0), g, cfg, chip_smoke.bench_vf0(g), args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
