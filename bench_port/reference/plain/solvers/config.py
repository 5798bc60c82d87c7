"""Solver configuration: a jax-free copy of ``fluidsolver_tpu.solvers.config``.

The fields, their defaults and their meaning are those of the JAX package's
``SolverConfig``; ``config_from_jax`` converts one of those into this one.
The port's steps support the subset that ``solvers/incomp.py`` and
``solvers/twophase.py`` check for (everything but a refresh policy other
than "solve" and "step", and a mesh).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from bench_port.reference.plain.core.bc import FlowBCs


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    # fluid properties (two-phase: gas == phase vf=0, liquid == vf=1)
    rho_gas: float = 1.0
    rho_liquid: float = 1.0
    visc_gas: float = 1e-3
    visc_liquid: float = 1e-3
    sigma: float = 0.0  # surface tension coefficient

    # time stepping
    cfl_max: float = 0.9
    dt_max: float = 1e-2
    num_subiter: int = 5

    # pressure solve (defaults match HYPRE PCG+PFMG tol/maxiter usage,
    # examples/IncompSolver.cpp:40-41)
    pressure_tol: float = 1e-6
    # Optional looser tolerance for all but the LAST subiteration's solve:
    # intermediate projections only feed the next subiteration's coupling
    # update (their error is re-corrected), so e.g. 1e-4 intermediate /
    # 1e-6 final preserves the end-of-step solution quality while cutting
    # total PCG iterations 22-23% (measured on the 64^2 gravity-drop golden
    # config, 15 steps: 345 -> 270 iters f64 / 267 f32, end-of-step field
    # deviation dU ~ 2e-10 f64 / 9e-9 f32, final p_res 1.5e-7 <= tol).
    # None = reference behavior (every subiteration at pressure_tol,
    # examples/IncompSolver.cpp:40-41).
    pressure_tol_intermediate: Optional[float] = None
    pressure_max_iter: int = 50
    pressure_pin: Optional[str] = None  # None | "left"|"right"|"bottom"|"top"
    # "boxmg" (PCG + operator-dependent blackbox-MG V-cycle, poisson/boxmg.py
    # — h-independent ~10-12 iters on 1000:1 jumps, 3.3x fewer than "mg"),
    # "mg" (PCG + PC-Galerkin geometric MG, the literal HYPRE PCG+PFMG
    # analog), "jacobi" (diag-precond CG, the Accelerate-backend analog,
    # src/LinearSolver_Accelerate.hpp), "none", or "direct" (dense, small grids)
    pressure_solver: str = "boxmg"
    # Krylov/outer method wrapped around ``pressure_solver``'s preconditioner,
    # mirroring the reference's HypreSolver enum {GMRES, PCG, BiCGSTAB, SMG,
    # PFMG} x HyprePrecond {SMG, PFMG, NONE} (src/HYPREUtility.hpp:35-36):
    # "pcg" (default, poisson/cg.py), "bicgstab", "gmres" (restarted,
    # right-preconditioned), or "mgsolve" (the V-cycle iterated AS the
    # solver — the SMG/PFMG-standalone analog; requires pressure_solver in
    # {"mg", "boxmg"}). All in poisson/krylov.py.
    pressure_method: str = "pcg"
    # Krylov subspace dimension per GMRES restart cycle
    # (HYPRE_StructGMRESSetKDim analog)
    pressure_gmres_restart: int = 20
    mg_pre: int = 2
    mg_post: int = 2
    # warm-start each subiteration's pressure solve from the previous
    # subiteration's increment. Guarded inside cg.solve_pcg (a bad guess is
    # discarded), and the stopping criterion stays ||b - A x||/||b|| < tol,
    # so solution quality is identical to the reference's always-cold start
    # (src/LinearSolver_StructHypre.hpp:123-127) — just fewer iterations.
    pressure_warm_start: bool = True
    # MG-hierarchy refresh policy for the two-phase solver: "solve" rebuilds
    # inside every subiteration's solve (exact operator/preconditioner
    # alignment); "step" builds ONCE per step from the first subiteration's
    # exact transported densities and reuses it for the remaining
    # subiterations (their densities differ only by successive CN fixed-point
    # increments) — 5x less setup at a small iteration penalty.
    pressure_precond_refresh: str = "solve"
    # run the MG V-cycle preconditioner in lower precision (e.g. "bfloat16"):
    # the V-cycle is HBM-bandwidth-bound, so halving the bytes nearly halves
    # its cost; the preconditioner stays a fixed SPD-to-rounding map.
    pressure_precond_dtype: Optional[str] = None

    # boundary conditions
    bcs: FlowBCs = None

    # outflow mass correction at the right boundary
    # (examples/IncompSolver.cpp:189-193)
    outflow_correction: bool = False

    # body force (RisingBubble gravity, examples/RisingBubble.cpp:453-455)
    gravity: Tuple[float, float] = (0.0, 0.0)

    # maintain a prescribed total mass flow through the x-boundaries
    # (periodic-channel driving, test/PeriodicChannel.cpp:187-197)
    flow_forcing: Optional[float] = None

    # FS_ARITHMETIC_VISC flag (src/FS.hpp:618)
    arithmetic_visc: bool = False

    # curvature method: "volume_matching" | "regression" | "convolved"
    curvature_method: str = "volume_matching"

    # capillary model: "pressure_jump" (the reference's production branch,
    # src/FS.hpp:439-466 — curvature-weighted jump in both momentum and the
    # Poisson RHS) | "tangent_force" (the explicit tangential-pull
    # alternative, src/FS.hpp:469-566 + examples/TwoPhaseSolver.cpp:348-355,
    # injected into the Poisson RHS only)
    surface_tension_method: str = "pressure_jump"
    # the reference's hard-coded 100x calibration constant on the
    # tangent-force divergence (examples/TwoPhaseSolver.cpp:351)
    tangent_force_scale: float = 100.0

    # immersed-boundary mode: None | "diffuse" | "sharp" | "luchini" |
    # "luchini_implicit"; the precomputed IB fields are passed to make_step
    ib_mode: Optional[str] = None

    # interfacial mass flux m_dot [mass/(length*time)] for phase-change
    # cases (examples/ExpandingBubble.cpp:222-241, 310-321): shifts the PLIC
    # planes into the liquid and adds the volume-expansion divergence source
    phase_change_mdot: Optional[float] = None

    # lane budget of the sparse active-cell VOF advection (vof/advect.py):
    # None = auto (default_max_active), 0 = dense all-cells path. Overflow
    # (interface longer than the budget) surfaces as an inf volume error.
    vof_max_active: Optional[int] = None

    # A/B debug variants of the geometric advection, mirroring the
    # reference's compile-time switches (src/VOF.hpp:216-298):
    # VOF_NO_CORRECTION (drop the flux-matched face caps) and
    # FS_VOF_ADVECT_WITH_STAGGERED_VELOCITY (RK4 through the raw staggered
    # velocity). Production path: both False.
    vof_no_correction: bool = False
    vof_staggered_backtrace: bool = False
