"""fused_rap on the card: against its twin, the parent, and timed.

    python3 tools/torch_rap_times.py [--parent DIR [--variant DIR ...]] [--probe DIR ...]

Builds the port's kernels (one nvcc per source, with ptxas's report of the
fused_rap kernels' registers, shared memory and spills), then runs
chip_smoke.py's phase-3 parts for fused_rap: the kernel against its twin at
every level of the 1026^2 and 1023 x 771 boxes and at the limits of its
tiling (f64 at rtol 1e-13 / atol 1e-11, f32 at the relative 1e-5, f32
bitwise logged), and its time and bound at the bench's three levels. With
--parent DIR (another checkout, e.g. the parent commit unpacked by git
archive), the parent's fused_rap is checked bitwise against this one's and
timed in turns with it (rap_turns); each --variant DIR (a checkout with
another csrc/fused_rap.cu) is held to the parent the same way. Each
--probe DIR (a checkout whose fused_rap kernel is cut short, e.g. ends
after one of its phases) is timed in turns with this checkout at the three
levels and not checked: its time is that of the phases it keeps. A shorter
run than chip_smoke.py for work on this one kernel; it needs one CUDA card.
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
    ap.add_argument("--probe", action="append", default=[], help="a checkout to time only (a cut-short kernel)")
    args = ap.parse_args()
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import _kernels, cuda_rap

    if not torch.cuda.is_available():
        print("torch_rap_times: no CUDA device", file=sys.stderr)
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
          *chip_smoke.ptxas_report((_kernels.BUILD_DIR / "build.log").read_text(), "fused_rap_kernel"), sep="\n", flush=True)
    errors = chip_smoke.Errors()
    for dtype in (torch.float64, torch.float32):
        for shape in ((1026, 1026), (1023, 771)):
            bitwise = []
            for op in chip_smoke.rap_levels(shape, dtype, device):
                trk, ck = cuda_rap.fused_rap_cuda(op)
                trt, ct = cuda_rap.fused_rap_twin(op)
                got, want = chip_smoke.fields_of(trk) + chip_smoke.fields_of(ck), \
                    chip_smoke.fields_of(trt) + chip_smoke.fields_of(ct)
                errors.compare("fused_rap", got, want, dtype, 1e-13, 1e-11, False,
                               f"{str(dtype)[6:]} level {tuple(op.aC.shape)}")
                bitwise.append(f"{tuple(op.aC.shape)} {all(torch.equal(a, b) for a, b in zip(got, want))}")
            print(f"{str(dtype)[6:]} {shape[0]}x{shape[1]}: fused_rap agrees with its twin at every level; bitwise: "
                  + ", ".join(bitwise), flush=True)
    chip_smoke.rap_limits_phase(device, errors)
    chip_smoke.rap_report_phase(device, None)
    for probe in args.probe:
        so = _kernels.build(csrc=Path(probe) / "fluidsolver_tpu_torch" / "csrc", build_dir=_kernels.BUILD_DIR / "probe")
        plib = chip_smoke.load_library(so)
        for op in chip_smoke.rap_levels((1026, 1026), torch.float32, device):
            ms = [chip_smoke.time_ms(lambda: chip_smoke.fused_rap_with(lib, op), 20, kernel=True)
                  for lib in (None, plib, plib, None)]
            print(f"probe {probe} at {op.aC.shape[0]}x{op.aC.shape[1]} (f32), device ms in turns: this {ms[0]:.4f}, "
                  f"probe {ms[1]:.4f}, probe {ms[2]:.4f}, this {ms[3]:.4f}", flush=True)
    if args.parent is None:
        return 0
    plib = chip_smoke.parent_lib(args.parent)
    print("this checkout against the parent:", flush=True)
    chip_smoke.rap_turns(device, plib, None)
    for var in args.variant:
        csrc = Path(var) / "fluidsolver_tpu_torch" / "csrc"
        build_dir = _kernels.BUILD_DIR / "variant"
        with contextlib.redirect_stdout(io.StringIO()):
            so = _kernels.build(verbose=True, csrc=csrc, build_dir=build_dir)
        print(f"variant {var} against the parent:",
              *chip_smoke.ptxas_report((build_dir / "build.log").read_text(), "fused_rap_kernel"), sep="\n", flush=True)
        chip_smoke.rap_turns(device, plib, chip_smoke.load_library(so))
    return 0


if __name__ == "__main__":
    sys.exit(main())
