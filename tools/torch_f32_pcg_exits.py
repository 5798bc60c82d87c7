"""The f32 PCG exits of the bench configuration in both packages, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_f32_pcg_exits.py [--n 256] [--steps 20]

Runs bench.py's two-phase configuration (a drop in an inflow channel,
1000:1, sigma 1/200, 5 subiterations, PCG + BoxMG V(2,2), tol 1e-6 with 3e-4
on subiterations 0-3, refresh "step") at n^2 in float32 for ``--steps``
steps: the JAX package's XLA path (jitted step) and the PyTorch port's plain
twins (CPU tensors). Every pressure solve is recorded (tolerance,
iterations, relative residual); a solve that stops below the iteration cap
with its residual above its tolerance ended on the f32 stagnation window.
Prints per step the PCG iterations of each package and the solves on the
stagnation window or at the cap, then one JSON line with both series.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def jax_run(n: int, steps: int) -> tuple:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from fluidsolver_tpu.core import bc
    from fluidsolver_tpu.core.grid import make_grid
    from fluidsolver_tpu.solvers import incomp, twophase
    from fluidsolver_tpu.solvers.config import SolverConfig
    from fluidsolver_tpu.vof.init import liquid_fraction_from_indicator

    g = make_grid(0.0, 1.0, n, 0.0, 1.0, n)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-6, visc_liquid=1e-3,
        sigma=1.0 / 200.0, cfl_max=0.9, dt_max=1e-2, num_subiter=5,
        pressure_tol=1e-6, pressure_max_iter=50,
        bcs=bc.FlowBCs(bc.Dirichlet(u=0.5, v=0.0), bc.Neumann(),
                       bc.Dirichlet(u=0.0, v=0.0), bc.Dirichlet(u=0.0, v=0.0)),
        outflow_correction=True, pressure_tol_intermediate=3e-4,
        pressure_precond_refresh="step",
    )
    solves = []
    solve = incomp.pressure_solve

    def recording(*args, tol=None, **kw):
        out = solve(*args, tol=tol, **kw)
        t = cfg.pressure_tol if tol is None else tol
        jax.debug.callback(lambda a, b, c: solves.append((float(a), int(b), float(c))), t, out[2], out[1],
                           ordered=True)
        return out

    incomp.pressure_solve = recording
    try:
        vf0 = liquid_fraction_from_indicator(lambda x, y: (x - 0.3) ** 2 + (y - 0.5) ** 2 <= 0.1**2, g)
        state = twophase.init_two_phase_state(g, cfg, vf0, dtype=jnp.float32)
        step = twophase.make_step(g, cfg)
        iters = []
        for _ in range(steps):
            state = step(state, 1e9)
            iters.append(int(state.flow.p_iter))
        jax.effects_barrier()
    finally:
        incomp.pressure_solve = solve
    return iters, solves, cfg.pressure_max_iter


def torch_run(n: int, steps: int) -> tuple:
    import torch

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    import chip_smoke
    from fluidsolver_tpu_torch.solvers import incomp, twophase

    g, cfg = chip_smoke.bench_case(n)
    solves = []
    solve = incomp.pressure_solve

    def recording(*args, tol=None, **kw):
        out = solve(*args, tol=tol, **kw)
        solves.append((float(cfg.pressure_tol if tol is None else tol), int(out[2]), float(out[1])))
        return out

    incomp.pressure_solve = recording
    try:
        vf0 = chip_smoke.bench_vf0(g)
        state = twophase.init_two_phase_state(g, cfg, vf0, torch.float32, "cpu")
        step = twophase.make_step(g, cfg, torch.float32, "cpu")
        iters = []
        for _ in range(steps):
            state = step(state, 1e9)
            iters.append(int(state.flow.p_iter))
    finally:
        incomp.pressure_solve = solve
    return iters, solves, cfg.pressure_max_iter


def exits(solves, cap: int, per_step: int) -> tuple:
    """(stagnation exits, capped solves) as (step, subiteration, iterations,
    residual, tolerance)."""
    stalled, capped = [], []
    for k, (tol, it, res) in enumerate(solves):
        row = (k // per_step + 1, k % per_step, it, res, tol)
        if it >= cap:
            capped.append(row)
        elif res > tol:
            stalled.append(row)
    return stalled, capped


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args()
    result = {"n": args.n, "steps": args.steps, "dtype": "float32"}
    for name, run in (("jax", jax_run), ("torch", torch_run)):
        iters, solves, cap = run(args.n, args.steps)
        stalled, capped = exits(solves, cap, 5)
        print(f"{name}: p_iter per step {iters} (sum {sum(iters)}); {len(solves)} solves")
        print(f"  stagnation exits (step, subiteration, iterations, residual, tol): {stalled}")
        print(f"  at the cap of {cap}: {capped}")
        result[name] = {"p_iter": iters, "stalled": stalled, "capped": capped,
                        "solves": [list(s) for s in solves]}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
