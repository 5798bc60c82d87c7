"""curvature and overlap on the card: against their twins, the parent, and timed.

    python3 tools/torch_vof_times.py [--parent DIR [--variant DIR ...]]

Builds the port's kernels (one nvcc per source, with ptxas's report of the
curvature and overlap kernels' registers, shared memory and spills), then
runs chip_smoke.py's phase-3b parts for these two kernels: each against its
twin, f64 and f32 -- curvature on the elvira planes of the bench drop
(1026^2), the 25-drop 1023 x 771 box, elvira's four limit fields and a field
with valid cells beside the ghost ring; overlap on every lane of the bench
drop's and the box's swirl lanes, the box's budgets n_active // 2 and
n_active, the box with a liquid corner for the fill lanes and a single lane;
then, in f32, curvature's time beside its fill-only floor on the bench drop,
and overlap's beside its floors (an empty launch of the same grid, the
gathers and cutoff test alone, the busiest lane alone) on the bench drop's
swirl lanes and on the lanes of the bench step's first two advections. With
--parent DIR (another checkout, e.g. the parent commit unpacked by git
archive), the parent's two kernels are checked bitwise against this one's on
the same inputs and timed in turns with them (curvature_turns,
overlap_turns); each --variant DIR (a checkout with another csrc/curvature.cu
or csrc/overlap.cu) is held to the parent the same way. A shorter run than
chip_smoke.py for work on these two kernels; it needs one CUDA card.
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

KERNELS = ("curvature_kernel", "overlap_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to hold to and time against")
    ap.add_argument("--variant", action="append", default=[], help="a checkout to hold to the parent and time")
    args = ap.parse_args()
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import _kernels

    if not torch.cuda.is_available():
        print("torch_vof_times: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)

    def report(build_dir):
        log = (build_dir / "build.log").read_text()
        return [line for k in KERNELS for line in chip_smoke.ptxas_report(log, k)]

    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        _kernels.build(verbose=True)
    _kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s", *report(_kernels.BUILD_DIR), sep="\n", flush=True)
    g_bench, cfg_bench = chip_smoke.bench_case()
    t0 = time.perf_counter()
    vf_bench = chip_smoke.bench_vf0(g_bench)
    print(f"bench drop vf0 in {time.perf_counter() - t0:.1f} s", flush=True)
    errors = chip_smoke.Errors()
    for dtype in (torch.float64, torch.float32):
        for name, dx, dy, vf_np in chip_smoke.curvature_fields(vf_bench, g_bench)[:2]:
            planes = chip_smoke.plic_planes(vf_np, dx, dy, dtype, device)
            chip_smoke.check_curvature(errors, planes, dx, dy, name == "bench drop", f"{str(dtype)[6:]} {name}")
        print(f"{str(dtype)[6:]}: curvature agrees with its twin on the bench drop and the 25-drop box", flush=True)
    chip_smoke.curvature_limits_phase(device, errors)
    chip_smoke.overlap_limits_phase(device, errors, vf_bench, g_bench)
    chip_smoke.curvature_report_phase(device, vf_bench, g_bench, None)
    step_args = chip_smoke.overlap_report_phase(device, vf_bench, g_bench, cfg_bench, None)
    if args.parent is None:
        return 0
    plib = chip_smoke.parent_lib(args.parent)
    print("this checkout against the parent:", flush=True)
    chip_smoke.curvature_turns(device, plib, None, vf_bench, g_bench)
    chip_smoke.overlap_turns(device, plib, None, vf_bench, g_bench, step_args)
    for var in args.variant:
        csrc = Path(var) / "fluidsolver_tpu_torch" / "csrc"
        build_dir = _kernels.BUILD_DIR / "variant"
        with contextlib.redirect_stdout(io.StringIO()):
            so = _kernels.build(verbose=True, csrc=csrc, build_dir=build_dir)
        print(f"variant {var} against the parent:", *report(build_dir), sep="\n", flush=True)
        vlib = chip_smoke.load_library(so)
        planes = chip_smoke.plic_planes(vf_bench, g_bench.dx, g_bench.dy, torch.float32, device)
        print(f"  its curvature fill-only floor {chip_smoke.curvature_fill_ms(vlib, planes, g_bench.dx, g_bench.dy):.4f} "
              "ms; its overlap floors (empty launch, gathers and cutoff test, the busiest lane alone) on bench step "
              f"2's lanes: {', '.join('%.4f' % t for t in chip_smoke.overlap_floors(vlib, step_args[-1]))} ms",
              flush=True)
        chip_smoke.curvature_turns(device, plib, vlib, vf_bench, g_bench)
        chip_smoke.overlap_turns(device, plib, vlib, vf_bench, g_bench, step_args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
