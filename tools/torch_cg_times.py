"""step_ab, step_c and step_init on the card: against their twins, the
parent, and timed.

    python3 tools/torch_cg_times.py [--parent DIR [--variant DIR ...]] [--graph]

Builds the port's kernels and prints ptxas's registers, shared memory and
spills for the step_ab, step_c and step_init kernels, with the resident
256-thread blocks an SM that those registers and that shared memory allow
(a cooperative launch needs every block resident), then runs chip_smoke.py's
phase-3c parts for them: kernels 5-8 against their twins at 1026^2 and
1023 x 771 (fused_kernel_phase) and the three CG kernels at the limits of
their virtual grid (cg_limits_phase). With --parent DIR (another checkout,
e.g. the parent commit unpacked by git archive), the parent's three CG
kernels are checked bitwise against this checkout's and timed in turns with
them (cg_turns); each --variant DIR (a checkout with another csrc/cg.cu) is
held to the parent the same way. With --graph, step_ab and step_c are
captured in a CUDA graph (torch.cuda.graph), replayed, and the replay held
bitwise to a direct call. A shorter run than chip_smoke.py for work on these
kernels; it needs one CUDA card.
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


KERNELS = ("step_ab_kernel", "step_c_kernel", "step_init_kernel")


def resident_blocks(regs: int, smem: int, threads: int = 256) -> int:
    """Blocks of ``threads`` threads an H100 SM holds at once with ``regs``
    registers a thread (allocated per warp in units of 256) and ``smem``
    bytes of shared memory a block (1 KB more reserved per block)."""
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = 65536 // (per_warp * (threads // 32))
    by_smem = 233472 // (smem + 1024)
    return min(by_regs, by_smem, 2048 // threads, 32)


def ptxas_report(log: str) -> list:
    """The ptxas lines of the CG kernels in a verbose build log, each
    kernel's with its resident blocks an SM."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = any(k in line for k in KERNELS)
            if keep and "Compiling" in line:
                lines.append(line.split("'")[1] if "'" in line else line)
        elif keep and ("registers" in line or "spill" in line):
            text = line.strip()
            if "registers" in line:
                regs = int(text.split("Used ")[1].split(" registers")[0])
                smem = int(re.search(r"(\d+) bytes smem", text).group(1)) if "bytes smem" in text else 0
                text += f" -> {resident_blocks(regs, smem)} resident blocks an SM"
            lines.append("    " + text)
    return lines


def fixed_cost(device) -> None:
    """The CG kernels' device time per call on levels small enough that
    their bytes take well under a microsecond: the launch, the grid
    barriers and the reductions (step_init in the bench form, two
    barriers)."""
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import cuda_cg

    for shape in ((64, 64), (258, 258)):
        inp = chip_smoke.cg_inputs(shape, torch.float32, device)
        op, x, r, p, z_raw, sum_r = (inp[k] for k in ("op", "x", "r", "p", "z_raw", "sum_r"))
        rz_prev = torch.tensor(float(x.numel()), dtype=x.dtype, device=device)
        t_ab = chip_smoke.time_ms(lambda: cuda_cg.step_ab_cuda(op, x, r, p, inp["rz_ab"]), 50, kernel=True)
        t_c = chip_smoke.time_ms(lambda: cuda_cg.step_c_cuda(r, z_raw, p, rz_prev, True, sum_r=sum_r), 50,
                                 kernel=True)
        t_i = chip_smoke.time_ms(lambda: cuda_cg.step_init_cuda(op, inp["b_near"], x, True), 50, kernel=True)
        print(f"f32 {shape[0]}x{shape[1]} ({-(-x.numel() // 256)} virtual blocks): step_ab {t_ab:.4f} ms, "
              f"step_c {t_c:.4f} ms, step_init {t_i:.4f} ms per call", flush=True)


def graph_probe(device) -> None:
    """step_ab and step_c captured in one CUDA graph, replayed, against a
    direct call on the same inputs."""
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import cuda_cg

    inp = chip_smoke.cg_inputs((1026, 1026), torch.float32, device)
    op, x, r, p, z_raw, sum_r = (inp[k] for k in ("op", "x", "r", "p", "z_raw", "sum_r"))
    rz_prev = torch.tensor(float(x.numel()), dtype=x.dtype, device=device)

    def body():
        ab = cuda_cg.step_ab_cuda(op, x, r, p, inp["rz_ab"])
        return ab + cuda_cg.step_c_cuda(r, z_raw, p, rz_prev, True, sum_r=sum_r)

    want = body()
    torch.cuda.synchronize()
    try:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            body()
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            got = body()
        graph.replay()
        torch.cuda.synchronize()
    except Exception as exc:  # report what the capture or replay raised
        print(f"graph probe: step_ab + step_c not captured: {type(exc).__name__}: {exc}", flush=True)
        return
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    print(f"graph probe: step_ab + step_c captured in one CUDA graph and replayed; replay bitwise equal to a "
          f"direct call: {same}", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", default=None, help="a checkout of another commit to hold to and time against")
    ap.add_argument("--variant", action="append", default=[], help="a checkout to hold to the parent and time")
    ap.add_argument("--graph", action="store_true", help="capture step_ab and step_c in a CUDA graph")
    args = ap.parse_args()
    import torch

    import chip_smoke
    from fluidsolver_tpu_torch.poisson import _kernels

    if not torch.cuda.is_available():
        print("torch_cg_times: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    print(torch.cuda.get_device_name(0), subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()) as out:
        _kernels.build(verbose=True)
    _kernels.lib()
    print(f"built in {time.perf_counter() - t0:.1f} s", *ptxas_report(out.getvalue()), sep="\n", flush=True)
    errors = chip_smoke.Errors()
    times = chip_smoke.fused_kernel_phase(device, errors)
    for k in ("step_ab", "step_c", "step_init"):
        print(f"{k} (f32 1026^2): kernel {times[k][0]:.4f} ms, twin {times[k][1]:.4f} ms, "
              f"bound {times[k][2]:.4f} ms", flush=True)
    chip_smoke.cg_limits_phase(device, errors)
    fixed_cost(device)
    if args.graph:
        graph_probe(device)
    if args.parent is None:
        return 0
    plib = chip_smoke.parent_lib(args.parent)
    print("this checkout against the parent:", flush=True)
    chip_smoke.cg_turns(device, plib, _kernels.lib())
    for var in args.variant:
        csrc = Path(var) / "fluidsolver_tpu_torch" / "csrc"
        with contextlib.redirect_stdout(io.StringIO()) as out:
            so = _kernels.build(verbose=True, csrc=csrc, build_dir=_kernels.BUILD_DIR / "variant")
        print(f"variant {var} against the parent:", *ptxas_report(out.getvalue()), sep="\n", flush=True)
        chip_smoke.cg_turns(device, plib, chip_smoke.load_library(so))
    return 0


if __name__ == "__main__":
    sys.exit(main())
