"""elvira on the card: against its twin, the parent, and timed.

    python3 tools/torch_elvira_times.py [--parent DIR [--variant DIR ...]]

Builds the port's kernels (one nvcc per source, with ptxas's report of the
elvira kernels' registers, shared memory and spills), then runs
chip_smoke.py's phase-3b parts for elvira: the kernel against its twin on
the bench drop (1026^2), the 25-drop 1023 x 771 box and the four limit
fields (every cell mixed, none, one, one with a NaN neighbour), f64 and
f32; the bench drop's mixed cells and the tiles and warps that hold them;
the kernel's time beside its fill-only floor. With --parent DIR (another
checkout, e.g. the parent commit unpacked by git archive), the parent's
elvira is checked bitwise against this one's and timed in turns with it
(elvira_turns); each --variant DIR (a checkout with another csrc/elvira.cu)
is held to the parent the same way. A shorter run than chip_smoke.py for
work on this one kernel; it needs one CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to hold to and time against")
    ap.add_argument("--variant", action="append", default=[], help="a checkout to hold to the parent and time")
    args = ap.parse_args()
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import _kernels

    if not torch.cuda.is_available():
        print("torch_elvira_times: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _kernels.build(verbose=True)
    _kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s",
          *chip_smoke.ptxas_report((_kernels.BUILD_DIR / "build.log").read_text(), "elvira_kernel"), sep="\n", flush=True)
    g_bench = chip_smoke.bench_case()[0]
    t0 = time.perf_counter()
    vf_bench = chip_smoke.bench_vf0(g_bench)
    print(f"bench drop vf0 in {time.perf_counter() - t0:.1f} s", flush=True)
    g_odd, vf_odd = chip_smoke.drops_vf(1023, 771, 25, seed=5)
    errors = chip_smoke.Errors()
    for dtype in (torch.float64, torch.float32):
        for name, g, vf_np, main_path in (("bench drop", g_bench, vf_bench, True),
                                          ("25 drops 1023x771", g_odd, vf_odd, False)):
            vf = torch.as_tensor(vf_np, dtype=dtype, device=device)
            rt, n_off = chip_smoke.check_elvira(errors, vf, g.dx, g.dy, main_path, f"{str(dtype)[6:]} {name}")
            print(f"{str(dtype)[6:]} {name}: {int(rt.valid.sum())} mixed cells, elvira agrees with its twin "
                  f"({n_off} near-tie cells)", flush=True)
    chip_smoke.elvira_limits_phase(device, errors)
    chip_smoke.elvira_report_phase(device, vf_bench, g_bench, None)
    if args.parent is None:
        return 0
    plib = chip_smoke.parent_lib(args.parent)
    print("this checkout against the parent:", flush=True)
    chip_smoke.elvira_turns(device, plib, None, vf_bench, g_bench)
    for var in args.variant:
        csrc = Path(var) / "fluidsolver_tpu_torch" / "csrc"
        build_dir = _kernels.BUILD_DIR / "variant"
        with contextlib.redirect_stdout(io.StringIO()):
            so = _kernels.build(verbose=True, csrc=csrc, build_dir=build_dir)
        print(f"variant {var} against the parent:",
              *chip_smoke.ptxas_report((build_dir / "build.log").read_text(), "elvira_kernel"), sep="\n", flush=True)
        chip_smoke.elvira_turns(device, plib, chip_smoke.load_library(so), vf_bench, g_bench)
    return 0


if __name__ == "__main__":
    sys.exit(main())
