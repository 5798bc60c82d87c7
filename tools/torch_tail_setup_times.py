"""tail_setup on the card: against its twin, the parent, and timed.

    python3 tools/torch_tail_setup_times.py [--parent DIR [--variant DIR ...]]

Builds the port's kernels (one nvcc per source, with ptxas's report of the
tail_setup kernel's registers, shared memory and spills), then runs
chip_smoke.py's phase-3 parts for tail_setup: the kernel against its twin
on the bench tail (129^2, 5 levels, f32 and f64) and on the domain tails
(tail_domain_phase, which also runs tail_cycle), and its dependency floor
(an empty cluster launch and the barriers of one setup). With --parent DIR
(another checkout, e.g. the parent commit unpacked by git archive), the
parent's tail_setup is checked bitwise against this one's and timed in
turns with it (tail_setup_turns); each --variant DIR (a checkout with
another csrc/tail.cu) is held to the parent the same way. A shorter run
than chip_smoke.py for work on this one kernel; it needs one CUDA card.
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
    from fluidsolver_tpu_torch.poisson import _kernels, cuda_tail

    if not torch.cuda.is_available():
        print("torch_tail_setup_times: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _kernels.build(verbose=True)
    _kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s", *chip_smoke.ptxas_report(out.getvalue(), "tail_setup_kernel"), sep="\n", flush=True)
    errors = chip_smoke.Errors()
    for dtype in (torch.float64, torch.float32):
        op, n_rem = chip_smoke.bench_tail(dtype, device)
        pk, pt = cuda_tail.build_tail_pack_cuda(op, n_rem), cuda_tail.build_tail_pack_twin(op, n_rem)
        err = errors.compare("tail_setup", [pk.buf], [pt.buf], dtype, 1e-10, 1e-10 * float(pt.buf.abs().max()),
                             True, f"{str(dtype)[6:]} bench tail pack")
        print(f"{str(dtype)[6:]} bench tail ({n_rem} levels): pack agrees with the twin, max|kernel - twin| "
              f"{err:.3e}, bitwise: {torch.equal(pk.buf, pt.buf)}", flush=True)
    chip_smoke.tail_domain_phase(device, errors)
    op, n_rem = chip_smoke.bench_tail(torch.float32, device)
    shapes = cuda_tail.level_shapes(tuple(op.aC.shape), n_rem)
    t = chip_smoke.time_ms(lambda: cuda_tail.build_tail_pack_cuda(op, n_rem), 50, kernel=True)
    sc, sb = chip_smoke.setup_barriers(shapes)
    launch = chip_smoke.cluster_launch_ms(device)
    b8, b1 = chip_smoke.barrier_us(device, 8, 0), chip_smoke.barrier_us(device, 1, 1024)
    print(f"tail_setup (f32 129^2, 5 levels): {t:.4f} ms; floor: empty cluster launch {launch:.4f} ms + {sc} "
          f"cluster ({b8:.4f} us) + {sb} block ({b1:.4f} us) barriers = {launch + (sc * b8 + sb * b1) / 1e3:.4f} ms",
          flush=True)
    if args.parent is None:
        return 0
    plib = chip_smoke.parent_lib(args.parent)
    print("this checkout against the parent:", flush=True)
    chip_smoke.tail_setup_turns(device, plib, None)
    for var in args.variant:
        csrc = Path(var) / "fluidsolver_tpu_torch" / "csrc"
        with contextlib.redirect_stdout(io.StringIO()) as out:
            so = _kernels.build(verbose=True, csrc=csrc, build_dir=_kernels.BUILD_DIR / "variant")
        print(f"variant {var} against the parent:", *chip_smoke.ptxas_report(out.getvalue(), "tail_setup_kernel"), sep="\n", flush=True)
        chip_smoke.tail_setup_turns(device, plib, chip_smoke.load_library(so))
    return 0


if __name__ == "__main__":
    sys.exit(main())
