"""fused_smooth on the card: against its twin, and timed.

    python3 tools/torch_smooth_times.py [--parent DIR]

Builds the port's kernels (one nvcc per source, with ptxas's report of
registers, shared memory and spills), then runs chip_smoke.py's phase-3
parts for fused_smooth alone: the BoxMG kernels against their twins at the
level shapes of the 1026^2 and 1023 x 771 boxes (kernel_phase), fused_smooth
at the limits of its tiling, and the report of its six launches of one
bench V-cycle with their bounds and the split of the 1026^2 restrict
launch. With --parent DIR (another checkout, e.g. the parent commit
unpacked by git archive), the parent's fused_smooth is checked bitwise
against this one's and timed in turns with it. A shorter run than
chip_smoke.py for work on this one kernel; it needs one CUDA card.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to time against")
    parent = ap.parse_args().parent
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import _kernels

    if not torch.cuda.is_available():
        print("torch_smooth_times: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    _kernels.build(verbose=True)
    _kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    errors = chip_smoke.Errors()
    times = chip_smoke.kernel_phase(device, errors, {})
    print(f"fused_smooth (f32 restrict 1026^2): kernel {times['fused_smooth'][0]:.4f} ms, "
          f"bound {times['fused_smooth'][2]:.4f} ms", flush=True)
    chip_smoke.smooth_limits_phase(device, errors)
    chip_smoke.smooth_report_phase(device, parent)
    return 0


if __name__ == "__main__":
    sys.exit(main())
