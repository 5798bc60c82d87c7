"""The DFG 2D-1 benchmark (Schaefer-Turek, Re = 20) run to its steady
state with the port, on the card.

    python3 tools/torch_dfg_steady.py [--ny 128] [--t-end 8] [--case sharp_ib_dfg] [--dtype float32]

Runs ``get_case(case, ny=ny)`` from rest to ``t_end`` with the bare step
and prints, every simulated second and at the end, the drag and lift
coefficients (the surface-stress integrals, ``cases.dfg.calc_c_d_surface``
and ``calc_c_l_surface``, and the row-wise ``calc_c_d``) and the pressure
difference dp, with the steps taken, the wall time and ms per step. The
literature's 2D-1 values are C_D 5.57-5.59, C_L 0.0104-0.0110 and dp
0.1172-0.1176. It needs one CUDA card (``--device cpu`` runs it on the
CPU at a small ``--ny``).
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    import torch

    from fluidsolver_tpu_torch.cases import dfg, get_case
    from fluidsolver_tpu_torch.core import sync

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--case", default="sharp_ib_dfg", choices=("sharp_ib_dfg", "luchini_ib_dfg", "diffuse_ib_dfg"))
    ap.add_argument("--ny", type=int, default=128)
    ap.add_argument("--t-end", type=float, default=8.0)
    ap.add_argument("--dtype", default="float32", choices=("float32", "float64"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.empty(0, device=args.device).device  # "cuda" -> "cuda:0", as the steps check it
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_dfg_steady: no CUDA device", file=sys.stderr)
            return 1
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        print(torch.cuda.get_device_name(0), "|", smi.stdout.strip())
    dtype = getattr(torch, args.dtype)
    case = get_case(args.case, ny=args.ny)
    g = case.grid
    um = dfg.u_mean(1, 0.0)
    t0 = time.perf_counter()
    state, step = case.make_state(dtype, device), case.make_step(dtype, device)
    print(f"{args.case} ny={args.ny} ({g.nx} x {g.ny}), {args.dtype}: set-up {time.perf_counter() - t0:.2f} s")

    def report(n_steps: int, wall: float) -> None:
        vals = (dfg.calc_c_d_surface(state.p, state.U, state.V, g, um), dfg.calc_c_d(state.p, state.U, g, um),
                dfg.calc_c_l_surface(state.p, state.U, state.V, g, um), dfg.calc_p_diff(state.p, g))
        cd_s, cd, cl_s, dp = (float(v) for v in vals)
        print(f"t = {float(state.t):.4f}: C_D {cd_s:.5f} (row-wise {cd:.5f}), C_L {cl_s:.5f}, dp {dp:.5f}; "
              f"{n_steps} steps, {wall:.1f} s, {1e3 * wall / max(n_steps, 1):.2f} ms/step", flush=True)

    n, next_report, t0 = 0, 1.0, time.perf_counter()
    while True:
        t = sync.read(state.t)
        if t >= args.t_end - 1e-6:
            break
        state = step(state, args.t_end)
        n += 1
        if t >= next_report:
            report(n, time.perf_counter() - t0)
            next_report += 1.0
    if device.type == "cuda":
        torch.cuda.synchronize()
    report(n, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
