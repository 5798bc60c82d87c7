"""The bf16 forms of fused_smooth (#1) and rb_sweep (#9) on the card:
against their twins, against another checkout's, and timed.

    python3 tools/torch_bf16_times.py [--parent DIR] [--variant DIR ...]

Builds the port's kernels (one nvcc per source) and prints ptxas's report
(registers, shared memory, spills) of the bf16 kernels, then runs
chip_smoke.py's phase 3e (both bf16 forms bitwise against their twins at
every level of the bf16 hierarchies of the 1026^2 and 1023 x 771 boxes and
on fused_smooth's 40 limit cases, with their times and bounds). With
--parent DIR (another checkout, e.g. the parent commit unpacked by git
archive), the parent's bf16 kernels are held torch.equal to this one's on
all of those inputs and timed in turns with them: rb_sweep at every "mg"
level of the 1026^2 box and one V-cycle's 52 launches, fused_smooth's 14
launches of one BoxMG cycle. Each --variant DIR (a checkout with other
csrc sources) is held and timed the same way; each --probe DIR (a
checkout whose kernels are cut short) is timed only. A shorter run than
chip_smoke.py for work on these two kernels; it needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import re
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to hold and time against")
    ap.add_argument("--variant", action="append", default=[], help="a checkout with other csrc sources")
    ap.add_argument("--probe", action="append", default=[], help="a checkout timed only (a cut-short kernel)")
    args = ap.parse_args()
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import _kernels

    if not torch.cuda.is_available():
        print("torch_bf16_times: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):   # the whole build log
        _kernels.build(verbose=True)
    _kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s", flush=True)
    build_log = (_kernels.BUILD_DIR / "build.log").read_text()
    for kernel in ("rb_sweep_bf16_kernel", "fused_smooth_bf16_kernel"):
        # one line a kernel: its template arguments, registers and spills
        for line in chip_smoke.ptxas_report(build_log, kernel):
            if not line.startswith(" "):
                print("\n" + kernel + line.split(kernel, 1)[1].split("EEEv")[0], end=" ")
            else:
                print(" ".join(re.findall(r"(\d+ registers|\d+ bytes spill stores)", line)), end=" ")
        print(flush=True)
    errors = chip_smoke.Errors()
    for name, (tk, tt, tb, by) in chip_smoke.bf16_phase(device, errors).items():
        print(f"{name}: kernel {tk:.4f} ms, twin {tt:.4f} ms, bound {tb:.4f} ms ({by})", flush=True)
    if args.parent is not None:
        chip_smoke.bf16_parent_phase(device, args.parent, args.variant, args.probe)
    return 0


if __name__ == "__main__":
    sys.exit(main())
