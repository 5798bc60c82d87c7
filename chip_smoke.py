"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--parent DIR]

Phases (each prints its own lines; any failure exits non-zero before the
result line):
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. the kernel build (one nvcc per source, sm_90a), with its time;
  3. each of the four BoxMG kernels against its plain PyTorch twin on the
     card, in f64 at the CPU tests' tolerances and in f32 at a relative
     (to max |twin|) tolerance of 1e-5 (fused_smooth and tail_cycle:
     bitwise), at the level shapes of a 1026^2
     and of an odd 1023 x 771 box; fused_rap also at the limits of its
     tiling (coarse levels smaller than a tile and with sides a multiple of
     no tile, 5- and 9-point; f32 bitwise logged) and timed at each of the
     bench's three levels beside its bound; with --parent DIR, the
     parent's fused_rap bitwise equal to this one's (all 17 planes, every
     level of both boxes and the limit levels, f32 and f64) and timed in
     turns at the three bench levels; kernel and twin times by CUDA events
     (the calls queued behind a device sleep, see time_ms) at the main
     path's shapes; the tail kernels also on a 160^2 tail of 6 levels, a
     66^2 tail with a 5-point finest operator and an odd 129 x 97 tail, f32
     and f64, V(2,2) and V(1,1) (tail_cycle bitwise in f32; tail_setup
     bitwise from call to call); tail_cycle's time on the tails that start
     at each level of the main path's tail (the per-level split) and the
     cost of an empty cluster and block barrier (its dependency floor);
     tail_setup's dependency floor (an empty cluster launch and its
     barriers); with --parent DIR (a checkout of another commit, e.g. the
     parent unpacked by git archive), that commit's tail_setup pack
     bitwise equal to this one's at the main path's and those three tails,
     f32 and f64, and its tail_setup and tail_cycle built from DIR and
     timed in turns with this one's (parent, this, this, parent) on the
     same inputs; fused_smooth at
     the limits of its tiling (sides a multiple of no tile, a level smaller
     than a tile, 5- and 9-point, V(1,1) and the deepest halo the wrapper
     admits), bitwise in f32; its six launches of one bench V-cycle
     (restrict and ec at 1026^2, 513^2 and 257^2) with each one's time and
     bound, and the 1026^2 restrict launch split into its half-steps, the
     residual and the restriction; with --parent DIR, the parent's
     fused_smooth bitwise against this one's and timed in turns at all six;
  3b. the three VOF kernels (elvira, curvature, overlap) against their twins
     on the bench drop's vf (1026^2 box) and on an odd 1023 x 771 box with
     25 drops: f64 at the CPU tests' tolerances, f32 at the relative 1e-5;
     times at the main path's shape; elvira also on four limit fields
     (every cell mixed, none, one, one with a NaN neighbour), with the
     bench drop's mixed cells, the tiles and warps that hold them, and its
     time beside a fill-only probe's (its memory floor); with --parent DIR,
     the parent's elvira bitwise equal to this one's (nx, ny, d, valid; the
     bench drop, the 25-drop box and the limit fields, f32 and f64) and
     timed in turns at 1026^2 f32; curvature also on the four limit
     fields and on a field with valid cells beside the ghost ring (the lone
     mixed cell and the field without one must give 0), with the bench
     drop's valid cells and its time beside a fill-only probe's; overlap
     also on the 25-drop box's budgets n_active // 2 (every lane active) and
     n_active (no fill lane), on the box with a liquid drop over the corner
     that the fill lanes gather, and on one lane, each with its working
     (lane, neighbour) pairs (those above the cutoff), and timed on the
     bench drop's swirl lanes and on the lanes of the bench step's first two
     advections beside its floors (an empty launch of the same grid, the
     gathers and cutoff test alone, the busiest lane alone); overlap also
     on quads (n0 = 4, the no_correction start polygons of the same
     backtrace) on the bench drop and the 25-drop box, f64 and f32, and
     timed at the bench drop; with --parent
     DIR, the parent's curvature (f32 and f64, every field above) and
     overlap (both outputs on every lane of every case above, f32 and f64)
     bitwise equal to this one's and both timed in turns, overlap on the
     swirl lanes and the bench step's; a lane budget below the active set
     must give an infinite volume error; the VOF stage, queued behind a
     device sleep, must return while the stream is still busy (no host read);
  3c. the fused PCG iteration (step_ab, step_c, step_init) and the fused
     momentum stage against their twins on the 1026^2 and 1023 x 771 boxes:
     f64 at the CPU tests' tolerances, f32 at the relative 1e-5 (a scalar
     relative to the larger of its value and the two-norm of its terms);
     step_c singular or not, with and without p; step_ab with alpha = 1,
     so that its update stands far above the f32 bound; step_init cold,
     warm with a kept and with a rejected guess, singular or not; times at
     the main path's shapes; the three CG kernels (one cooperative launch
     each) also where their virtual grid of summation differs: 64^2 (16
     virtual blocks), 37 x 29 (n not a multiple of 256), 2050 x 1026 (more
     points a thread than it holds in registers) and 1026^2 f64 (fewer
     resident blocks than virtual ones), and each called twice with
     bitwise-equal results; with --parent DIR, the parent's step_ab,
     step_c and step_init on the same inputs bitwise equal to this
     commit's (every output and scalar, f64 and f32, every shape above,
     all four forms of step_c, all six of step_init) and timed in turns
     with them at 1026^2 f32;
  3d. the red-black sweep kernel (rb_sweep) against its twin at every level
     shape of the "mg" hierarchy of the 1026^2 and 1023 x 771 boxes, both
     orders, from a zero and a random x: f64 at the CPU tests' 1e-12, f32 at
     the relative 1e-5 (bitwise logged); times at 1026^2; with --parent
     DIR, the parent's rb_sweep torch.equal to this one's at every "mg"
     level of the 1026^2 box (f32 and f64, both orders) and timed in turns,
     and the parent's fused_smooth torch.equal in f64 too at the six
     launches of one bench V-cycle;
  3e. the bf16 forms (pressure_precond_dtype="bfloat16"): fused_smooth on
     bf16 storage (f32 arithmetic) in its four forms at every level above
     the coarsest of the bf16 BoxMG hierarchies of both boxes and at the
     limits of its tiling (389 x 277 and 37 x 29 5-point, 195 x 139 and
     12 x 10 9-point, V(1,1), V(2,2), the deepest halos, the sweep pair),
     and rb_sweep in bf16 at every level of the bf16 "mg" hierarchies of
     both boxes (both orders, zero and random x): each torch.equal to its
     twin; the bf16 V-cycle's launches timed beside the f32 kernel on the
     uncast levels, rb_sweep bf16 beside f32 at 1026^2, with their bounds;
     with --parent DIR, the parent's bf16 kernels torch.equal to this
     one's on every one of those inputs, and timed in turns (parent, this,
     this, parent): rb_sweep at every "mg" level of the 1026^2 box and one
     V-cycle's 52 launches, fused_smooth's 14 launches of one BoxMG cycle,
     each with its bound;
  4. lid_driven(n=256), f64, pressure_tol=1e-11, 3 steps: the GPU (kernels)
     against the CPU (twins);
  4b. the golden two-phase drop (64^2, 15 steps, f64, tol 1e-10): GPU
     against CPU and both against tests/goldens/two_phase_drop.npz; the GPU
     run must launch kernels 5-8;
  4c. lid_driven(n=64), f64, tol 1e-11, 2 steps, GPU against CPU for every
     pressure method (pcg, bicgstab, gmres, mgsolve) and preconditioner
     (mg, boxmg, jacobi, none) and the direct solve; the "mg" runs must
     launch rb_sweep;
  4d. the driver (``driver.Simulation``) on the card against the
     CPU, f64: two_phase_channel(ny=16), tol 1e-11, 3 steps (every observed
     column within 1e-9 of its scale, iter(p) within 1 a step, the residual
     below the tolerance; final U, V, p, vf within 1e-9); vof_tgv(n=64), 10
     kinematic steps (vf within 1e-9, every step's volume error below
     1e-12);
  4e. GPU against CPU, f64, tol 1e-11, 3 steps each, held like 4d:
     two_phase_channel(ny=16) with the tangent force, the regression
     curvature, the dense advection, no_correction and the staggered
     backtrace, and at ny=32 with the convolved curvature;
     expanding_bubble(n=32); the four IB channels and growing_ib at ny=16;
  4f. GPU against CPU, f64, 3 steps, with pressure_precond_dtype=
     "bfloat16": two_phase_channel(ny=16) on BoxMG and lid_driven(n=64) on
     "mg" at tol 1e-11, held like 4e; two_phase_channel(ny=16) on "mg" at
     its tol 1e-6, whose solves end unconverged (at the cap or stalled):
     final fields to 1e-3, iter(p) to 2 a step;
  4g. ops/extrapolate.py and ib/mls.py, GPU against CPU in f64 at the CPU
     tests' sizes and tolerances: the constant and divergence-free
     extrapolation of a Taylor-Green velocity known in a circle (24^2, and
     the sealed projection at 32^2) to 1e-10 with the CG iterations within
     1 (sealed: 2) and one host read an iteration; the MLS weights, shape
     functions, interpolation and the 5-point and nearest-neighbour
     samples of a 32^2 field to 1e-12 (nearest neighbour exact);
  4h. f64 on the card against the CPU: lid_driven(64)'s and the golden
     drop's BoxMG hierarchies end in the dense coarsest inverse with no
     tail (the f32 1026^2 operator's still starts its tail at 129^2), and
     take the CPU's PCG iterations solve by solve (each logged); kernel #4
     (fused_rap) against galerkin_boxmg (comb probing) on the same operator
     and transfer at every fused_rap level of the 1026^2 and 1023 x 771
     boxes, f64 within 1e-12 of each plane's largest value, f32 within the
     rounding bound of the two summation orders (galerkin_f32_bound);
     conserved_quantities of the golden drop at step 0 and 15 within 1e-12
     of the sum of its absolute terms (mass drift logged); the drop under
     FS_NAN_POISON=1 torch.equal over the interior to the unpoisoned run on
     the card and the CPU, every CPU dmom/drho ring NaN; the core/fields.py
     helpers and l1_norm on the bench's initial state (max, min exact,
     sums within 1e-12);
  5. lid_driven(n=1024), f32, 20 steps: ms/step, PCG iterations, max |div|,
     host syncs per step, launch counts (the V-cycle and the PCG kernels),
     and the kernels seen by torch.profiler over make_step plus one step;
  6. the two-phase bench configuration (a drop in an inflow channel, 1024^2,
     1000:1, 5 subiterations, refresh "step", PCG + BoxMG, f32), 20 steps:
     ms/step, p_iter (Σp_iter must be the recorded 598), host syncs, VOF
     volume error, vf bounds and volume drift, max |div|, the exact launch
     counts of its eleven kernels, and a
     profiler split of 3 steps (kernels, rest of the VOF stage, pressure
     solve, other work, idle share), in which the profiler must see one
     device kernel per step_ab, step_c, step_init, tail_setup, fused_rap,
     elvira, curvature and overlap call, and their in-path device time per
     call;
  7. the same configuration on PCG + "mg" (the JAX package's default
     preconditioner), 10 steps: the phase 6 report (Σp_iter must be the
     recorded 1735), the solves that stopped
     at the iteration cap or above their tolerance, the exact launch counts
     (rb_sweep: (PCG iterations + solves) x sweeps per V-cycle; kernels 5-8
     and 10-12; no BoxMG kernel), and a profiler split of 2 steps;
  8. the driver at full size: (a) two_phase_channel(ny=448) (2240 x 448,
     f32, VTK), 10 steps in turns with 10 bare step calls from the same
     initial state (bare, driver, driver, bare): the state torch.equal to
     the bare loop's, host syncs exactly the bare loop's + 1 a step + 1 a
     frame (at least two frames), the same launches of the eleven kernels,
     ms/step of both (CUDA events) and ms per VTK frame; (b) driver.main on
     stationary_drop(n=256), f32, three steps with --profile: n_steps + 1
     monitor rows, the twophase.pressure range in the trace; (c) vof_tgv(
     n=1024), f64, 20 kinematic steps: the Taylor-Green invariants, one
     elvira and one overlap launch a step and no other kernel, one host sync
     a step, no host read in the step, ms/step;
  9. the bench configuration of phase 6 with each of the options of 4e, 5
     steps (the dense advection 2): phase 6's report and exact launches
     (no curvature launch under regression or convolved, no overlap
     launch on the dense path, one quad overlap launch a step under
     no_correction), the peak device memory; the dense advection against
     the sparse one on the f64 inputs of the bench's steps 1 and 2
     (max |dvf| <= 1e-12), with its peak memory;
  10. expanding_bubble(n=1024, m_dot=1), f32, 10 steps: ms/step,
     launches, vf bounds, the gas area's growth above 0.3 of 2 pi r m_dot
     t;
  11. the IB cases through the driver at about the bench's cell count
     (diffuse, sharp quadratic, Luchini and Luchini implicit channels at
     2240 x 448, growing_ib at 1728 x 576), f32, 10 steps each: the
     set-up time, ms/step, p_iter, host syncs (the bare step's + 1), one
     hierarchy at make_step and none a step, no NaN, |U| deep in the solid
     below 0.15, max |div| below 1e-3 (growing_ib: less its source and
     the singular solve's constant, below 1e-3 of the source's scale); the
     sharp channel with the linear weights is reported, not held;
  12. the bench configuration with pressure_precond_dtype="bfloat16", on
     BoxMG for 20 steps and on "mg" for 10: phase 6's report, the exact
     launches (no tail_cycle or tail_setup; fused_rap for every level above
     the coarsest once a step; two bf16 fused_smooth launches a level a
     V-cycle; the bf16 rb_sweep on every "mg" level), host syncs exactly
     1 + p_iter + one a solve that ends before its cap, the solves at the
     cap or on the stagnation window (none non-finite), peak memory, a
     profiler split; Σp_iter, the bf16 launches a step and their device ms
     a step logged beside the recorded ones; the bf16 set-up (the f32 build,
     the cast and the dense coarse inverse) must not drain the stream;
  13. the DFG 2D-1 cases (diffuse, sharp quadratic, Luchini) at ny=448
     (2403 x 448) through the driver, f32, 10 steps each, held as phase 11
     with C_D, C_L and dp reported; immersed_interface(n=1024) with 1287
     markers, 10 steps: no NaN, max|div| below 1e-3;
  14. the x-slab mesh (parallel/), its slabs on the cards there are
     (SlabMesh(["cuda:0"] * ndev) on one card), each slab's device printed:
     (a) make_sharded_smoother torch.equal to the global fused_smooth (x
     and r) for ndev 2, 4 and 8 at the six V(2,2) phases of one distributed
     bench cycle (1026^2, 513^2, 257^2, padded with identity rows to the
     plan's rows), the kernel torch.equal to its twin on every extended
     slab, and at ndev 4 each phase timed in turns with the global launch
     beside both bounds; at ndev 4 on the distributed hierarchy of the
     bench's pressure operator, the kernel torch.equal to its twin on every
     slab of every distributed level, both phases of the cycle, at the
     shapes the mesh step gives it (level 0's 284 x 1026 slabs timed for the
     kernels line); (b) the distributed levels (#4 on 2-row extended slabs),
     gathered and cropped, torch.equal to the single-device fused_rap
     levels 0..L_dist of the bench's pressure operator, ndev 2 and 4; (c)
     solve_pcg_sharded against cg.solve_pcg(precond="boxmg") on that
     operator (f32, tol 1e-6, V(2,2)), ndev 2 and 4, cold and warm:
     iterations within 1, both residuals at most tol, the solutions within
     10 tol, one host read an iteration, a prebuilt hierarchy torch.equal;
     (d) the mesh step (4 slabs) GPU against CPU in f64 on
     two_phase_channel(16) (tol 1e-11) and the flagship drop at n=48 (tol
     1e-6), 3 steps: 1e-9 and the same p_iter; (e) the mesh step on the
     bench configuration (1024^2, f32, 4 slabs on the card): step 1 against
     the single-device step (vf within 1e-5, each solve's iterations within
     1), then 10 steps of each (the mesh's launch counts exact: every
     kernel of the path launched), no NaN, vf bounds, max|div| below 1e-3,
     host reads exactly 1 + p_iter + one a solve below the cap, ms/step of
     both, a 3-step profile of the mesh step (idle share); (f) a shard's
     lane overflow gives an infinite volume error.
The second-to-last line is a JSON object with one entry per kernel (the
launches from phase 6, rb_sweep's from phase 7; overlap's quad variant
under "n0_4", its launches from phase 9; the bf16 forms of fused_smooth
and rb_sweep under "bf16", their launches from phase 12; kernel #1 on the
mesh step's slabs as "fused_smooth_local", its launches and the mesh
step's launches of every kernel from phase 14e); the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPLACES = {
    "fused_rap": ("fluidsolver_tpu_torch/csrc/fused_rap.cu",
                  "fluidsolver_tpu/poisson/pallas_rap.py:250"),
    "fused_smooth": ("fluidsolver_tpu_torch/csrc/fused_smooth.cu",
                     "fluidsolver_tpu/poisson/pallas_vcycle.py:357"),
    "tail_setup": ("fluidsolver_tpu_torch/csrc/tail.cu",
                   "fluidsolver_tpu/poisson/pallas_tail.py:403"),
    "tail_cycle": ("fluidsolver_tpu_torch/csrc/tail.cu",
                   "fluidsolver_tpu/poisson/pallas_tail.py:455"),
    "elvira": ("fluidsolver_tpu_torch/csrc/elvira.cu",
               "fluidsolver_tpu/vof/pallas_elvira.py:51"),
    "curvature": ("fluidsolver_tpu_torch/csrc/curvature.cu",
                  "fluidsolver_tpu/vof/pallas_curvature.py:92"),
    "overlap": ("fluidsolver_tpu_torch/csrc/overlap.cu",
                "fluidsolver_tpu/vof/pallas_advect.py:157"),
    "step_ab": ("fluidsolver_tpu_torch/csrc/cg.cu",
                "fluidsolver_tpu/poisson/pallas_cg.py:109"),
    "step_c": ("fluidsolver_tpu_torch/csrc/cg.cu",
               "fluidsolver_tpu/poisson/pallas_cg.py:287"),
    "step_init": ("fluidsolver_tpu_torch/csrc/cg.cu",
                  "fluidsolver_tpu/poisson/pallas_cg.py:462"),
    "fused_momentum": ("fluidsolver_tpu_torch/csrc/momentum.cu",
                       "fluidsolver_tpu/ops/pallas_momentum.py:247"),
    "rb_sweep": ("fluidsolver_tpu_torch/csrc/rb_sweep.cu",
                 "fluidsolver_tpu/poisson/pallas_smoother.py:54"),
    # no TPU kernel: the JAX package's jnp RHS, which XLA fuses on the TPU
    "fused_rhs": ("fluidsolver_tpu_torch/csrc/rhs.cu",
                  "none: fluidsolver_tpu/solvers/twophase.py:196-206 (jnp, fused by XLA)"),
}
# the kernels of the reference's fused composition (its FS_PALLAS_CG and
# FS_PALLAS_MOMENTUM), ported in one slice
FUSED = ("step_ab", "step_c", "step_init", "fused_momentum")
# the kernels of the BoxMG bench step (phase 6); rb_sweep runs on the "mg"
# step (phase 7) instead of the four BoxMG kernels
BOXMG = ("fused_rap", "fused_smooth", "tail_setup", "tail_cycle")
BOXMG_STEP = tuple(k for k in REPLACES if k != "rb_sweep")
MG_STEP = tuple(k for k in REPLACES if k not in BOXMG)
# the names the kernels carry in a profiler trace (the bf16 forms of #1
# and #9 are kernels of their own)
TRACE_NAMES = {k: (k + "_kernel", k + "_bf16_kernel") for k in REPLACES}
# kernels redesigned as one launch per wrapper call (the profiler must see
# one device kernel per call on the bench step)
ONE_LAUNCH = ("step_ab", "step_c", "step_init", "tail_setup", "fused_rap", "elvira", "curvature", "overlap",
              "fused_rhs")
F32_RTOL = 1e-5
# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, and
# non-tensor-core FLOP/s by dtype
PEAK_BYTES = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.float64: 34e12}


class PhaseFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


def bound(nbytes: float, flops: float, dtype) -> tuple:
    """(least time in ms for these bytes and operations at the card's
    peaks, "bytes" or "operations")."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    # a bf16 kernel computes in f32: its operations count at the f32 peak
    t_ops = flops / PEAK_FLOPS[torch.promote_types(dtype, torch.float32)] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def itemsize(dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---- inputs ----------------------------------------------------------------
def random_operator(n: int, m: int, seed: int, dtype, device):
    """The pressure operator of a box of (n-2) x (m-2) cells whose face
    densities are 1 or 1000 at random (a two-phase-like jump field)."""
    from fluidsolver_tpu_torch.core.grid import make_grid
    from fluidsolver_tpu_torch.poisson import linsys

    rng = np.random.default_rng(seed)
    g = make_grid(0.0, 1.0, n - 2, 0.0, 1.3, m - 2)
    rho_u = torch.as_tensor(np.where(rng.random(g.shape_u) > 0.5, 1000.0, 1.0), dtype=dtype, device=device)
    rho_v = torch.as_tensor(np.where(rng.random(g.shape_v) > 0.5, 1000.0, 1.0), dtype=dtype, device=device)
    return linsys.assemble_pressure_operator(rho_u, rho_v, g.dx, g.dy, None)


def random_field(shape, seed, dtype, device):
    return torch.as_tensor(np.random.default_rng(seed).normal(size=shape), dtype=dtype, device=device)


def fields_of(obj) -> list:
    return [getattr(obj, f.name) for f in dataclasses.fields(obj)]


def bench_case(n: int = 1024):
    """bench.py's two-phase configuration with the port's SolverConfig: a
    drop (r = 0.1 at (0.3, 0.5)) in a unit channel with a uniform 0.5
    inflow, 1000:1 density, sigma = 1/200, 5 subiterations, PCG + BoxMG
    with a 3e-4 intermediate tolerance and one hierarchy per step."""
    from fluidsolver_tpu_torch.core import bc
    from fluidsolver_tpu_torch.core.grid import make_grid
    from fluidsolver_tpu_torch.solvers.config import SolverConfig

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
    return g, cfg


def bench_vf0(g) -> np.ndarray:
    from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator

    return liquid_fraction_from_indicator(lambda x, y: (x - 0.3) ** 2 + (y - 0.5) ** 2 <= 0.1**2, g)


def drops_vf(n: int, m: int, n_drops: int, seed: int):
    """An (n-2) x (m-2) grid with random drops: vf = clip(1/2 - phi/h) of
    the signed distance phi to the nearest drop (a mixed band about one
    cell wide)."""
    from fluidsolver_tpu_torch.core.grid import make_grid

    g = make_grid(0.0, 1.0, n - 2, 0.0, (m - 2) / (n - 2), m - 2)
    rng = np.random.default_rng(seed)
    X, Y = np.meshgrid(g.xm, g.ym, indexing="ij")
    phi = np.full(X.shape, np.inf)
    for _ in range(n_drops):
        cx, cy = rng.uniform(0.08, 0.92), rng.uniform(0.08, g.y_max - 0.08)
        r = rng.uniform(0.015, 0.04)
        phi = np.minimum(phi, np.hypot(X - cx, Y - cy) - r)
    return g, np.clip(0.5 - phi / g.dx, 0.0, 1.0)


def swirl_velocity(g, dtype, device):
    """A solenoidal swirl U = sin(pi x) cos(pi y), V = -cos(pi x) sin(pi y)
    on the staggered faces, and its cell-centered interpolation."""
    from fluidsolver_tpu_torch.ops import stencil

    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    Xv, Yv = np.meshgrid(g.xm, g.y, indexing="ij")
    U = torch.as_tensor(np.sin(np.pi * Xu) * np.cos(np.pi * Yu), dtype=dtype, device=device)
    V = torch.as_tensor(-np.cos(np.pi * Xv) * np.sin(np.pi * Yv), dtype=dtype, device=device)
    return U, V, stencil.interp_u_center(U), stencil.interp_v_center(V)


def ptxas_report(build_log: str, kernel: str) -> list:
    """The ptxas lines (registers, shared memory, spills) of the kernels
    whose mangled names hold ``kernel``, from a verbose build log."""
    lines, keep = [], False
    for line in build_log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = kernel in line
            if keep and "Compiling" in line:
                lines.append(line.split("'")[1] if "'" in line else line)
        elif keep and ("registers" in line or "spill" in line):
            lines.append("    " + line.strip())
    return lines


# ---- comparisons -------------------------------------------------------------
class Errors:
    """Max abs error per kernel over the f32 comparisons at the main path's
    shapes (reported in the kernels line)."""

    def __init__(self):
        self.max_abs = {}

    def compare(self, name, got, want, dtype, rtol, atol, main_path, what, mask=None, scale=None):
        """f64: |got - want| <= atol + rtol |want|; f32: max |got - want| <=
        F32_RTOL times ``scale`` (default max |want|)."""
        worst = 0.0
        for g, w in zip(list(got), list(want)):
            diff = (g - w).abs()
            if mask is not None:
                diff = torch.where(mask, diff, torch.zeros_like(diff))
            if dtype == torch.float64:
                ok = bool((diff <= atol + rtol * w.abs()).all())
                bound_txt = "atol %g rtol %g" % (atol, rtol)
            else:
                s = float(w.abs().max()) if scale is None else scale
                ok = float(diff.max()) <= F32_RTOL * max(s, 1e-30)
                bound_txt = "%g x %g = %g" % (F32_RTOL, s, F32_RTOL * s)
            worst = max(worst, float(diff.max()))
            require(ok, f"{name} {what}: max|kernel - twin| = {float(diff.max()):.3e} exceeds {bound_txt}")
        if main_path and dtype == torch.float32:
            self.max_abs[name] = max(self.max_abs.get(name, 0.0), worst)
        return worst


def time_ms(fn, reps: int, kernel: bool = False) -> float:
    """Time per call of ``fn`` on the card: CUDA events around ``reps`` calls
    queued behind a ~0.1 s device sleep, so that the calls run back to back
    once the sleep ends and the host's enqueue (Python, allocation, launch)
    is hidden. A ``kernel`` (a few launches per call) must be enqueued before
    the sleep ends; a twin of many launches may fill the launch queue first,
    and then its time includes the host's stalls."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    hidden = not start.query()
    torch.cuda.synchronize()
    require(hidden or not kernel, "the host did not enqueue the timed kernel calls within the device sleep")
    return start.elapsed_time(end) / reps


# ---- phase 3 ---------------------------------------------------------------
def kernel_phase(device, errors: Errors, tail_start: dict) -> dict:
    """Returns name -> (kernel ms, twin ms, bound ms, bound by); puts the
    main path's f32 tail (its operator, levels and b) into ``tail_start``."""
    from fluidsolver_tpu_torch.poisson import boxmg, cuda_rap, cuda_tail, cuda_vcycle

    times = {}
    for dtype, shape, main in ((torch.float64, (1026, 1026), True), (torch.float32, (1026, 1026), True),
                               (torch.float64, (1023, 771), False), (torch.float32, (1023, 771), False)):
        tag = f"{str(dtype)[6:]} {shape[0]}x{shape[1]}"
        s = itemsize(dtype)
        op = random_operator(*shape, seed=13, dtype=dtype, device=device)
        level = 0
        while True:
            lshape = tuple(op.aC.shape)
            n_rem = boxmg._remaining_depth(lshape, level)
            b = random_field(lshape, 100 + level, dtype, device)
            if boxmg.tail_fits(lshape, n_rem):
                pk = cuda_tail.build_tail_pack_cuda(op, n_rem)
                pt = cuda_tail.build_tail_pack_twin(op, n_rem)
                xk = cuda_tail.tail_cycle_cuda(pk, b, 2, 2)
                xt = cuda_tail.tail_cycle_twin(pt, b, 2, 2)
                errors.compare("tail_setup", [xk], [xt], dtype, 1e-10, 1e-10 * float(xt.abs().max()), main,
                               f"{tag} level {lshape} ({n_rem} levels), through one cycle")
                errors.compare("tail_setup", [pk.buf], [pt.buf], dtype, 1e-10, 1e-10 * float(pt.buf.abs().max()),
                               main, f"{tag} level {lshape} pack")
                xk = cuda_tail.tail_cycle_cuda(pt, b, 2, 2)
                errors.compare("tail_cycle", [xk], [xt], dtype, 1e-12, 1e-12 * float(xt.abs().max()), main,
                               f"{tag} level {lshape} V(2,2)")
                require(dtype == torch.float64 or torch.equal(xk, xt),
                        f"tail_cycle {tag} level {lshape} V(2,2): not bitwise in f32")
                if main and dtype == torch.float32:
                    tail_start.update(op=op, n_rem=n_rem, b=b)
                    shapes = cuda_tail.level_shapes(lshape, n_rem)
                    pts = [a * c for a, c in shapes]
                    # setup: 9 planes in, the pack out; ~540 flops per coarse point
                    bnd = bound(s * (9 * pts[0] + pk.buf.numel()), 540 * sum(pts[1:]), dtype)
                    times["tail_setup"] = (
                        time_ms(lambda: cuda_tail.build_tail_pack_cuda(op, n_rem), 20, kernel=True),
                        time_ms(lambda: cuda_tail.build_tail_pack_twin(op, n_rem), 3), *bnd)
                    # V(2,2): pack + b in, x out; ~100 flops per point per level,
                    # plus 32 sweeps of ~36 flops per point on the coarsest
                    bnd = bound(s * (pk.buf.numel() + 9 * pts[0] + 2 * pts[0]),
                                100 * sum(pts) + 32 * 36 * pts[-1], dtype)
                    times["tail_cycle"] = (
                        time_ms(lambda: cuda_tail.tail_cycle_cuda(pt, b, 2, 2), 50, kernel=True),
                        time_ms(lambda: cuda_tail.tail_cycle_twin(pt, b, 2, 2), 3), *bnd)
                log(f"  {tag}: tail at {lshape}, {n_rem} levels: setup and cycle agree")
                break
            trk, ck = cuda_rap.fused_rap_cuda(op)
            trt, ct = cuda_rap.fused_rap_twin(op)
            errors.compare("fused_rap", fields_of(trk) + fields_of(ck), fields_of(trt) + fields_of(ct),
                           dtype, 1e-13, 1e-11, main, f"{tag} level {lshape}")
            x0 = random_field(lshape, 200 + level, dtype, device)
            ec = random_field(trt.pW.shape, 300 + level, dtype, device)
            variants = {
                "plain": dict(x0=x0, colors=(False, True, False, True)),
                "residual": dict(colors=(True, False, True, False), residual=True),
                "restrict": dict(colors=(True, False, True, False), tr=trt, restrict=True),
                "ec": dict(x0=x0, colors=(False, True, False, True), tr=trt, ec=ec),
            }
            for vname, kw in variants.items():
                check_smooth(errors, op, b, kw, main, f"{tag} level {lshape} variant {vname}")
            if main and dtype == torch.float32 and level == 0:
                kw = variants["restrict"]
                times["fused_rap"] = (time_ms(lambda: cuda_rap.fused_rap_cuda(op), 20, kernel=True),
                                      time_ms(lambda: cuda_rap.fused_rap_twin(op), 3), *rap_bound(op))
                times["fused_smooth"] = (
                    time_ms(lambda: cuda_vcycle.fused_smooth_cuda(op, b, **kw), 50, kernel=True),
                    time_ms(lambda: cuda_vcycle.fused_smooth_twin(op, b, **kw), 10), *smooth_bound(op, kw))
            log(f"  {tag}: level {lshape}: fused_rap and fused_smooth (4 variants) agree")
            op = ct
            level += 1
    return times


# ---- phase 3: fused_rap ------------------------------------------------------
def rap_bound(op) -> tuple:
    """fused_rap's bound on ``op``: its ncoef planes in, 8 weight and 9
    coefficient coarse planes out; ~540 flops per coarse point."""
    from fluidsolver_tpu_torch.poisson import boxmg

    n, m = op.aC.shape
    ncm = ((n + 1) // 2) * ((m + 1) // 2)
    return bound(itemsize(op.aC.dtype) * (len(boxmg.coefs(op)) * n * m + 17 * ncm), 540 * ncm, op.aC.dtype)


def fused_rap_with(lib, op) -> list:
    """cuda_rap.fused_rap_cuda through the library ``lib`` (None: this
    commit's): its 17 output planes."""
    from fluidsolver_tpu_torch.poisson import cuda_rap

    with kernel_library(lib):
        tr, c = cuda_rap.fused_rap_cuda(op)
    return fields_of(tr) + fields_of(c)


def rap_levels(shape, dtype, device) -> list:
    """The operators fused_rap coarsens in a hierarchy of a finest box of
    ``shape``: the random jump operator and its Galerkin coarse operators
    (fused_rap_twin), one per level above the tail (1026^2: 1026^2 5-point,
    513^2 and 257^2 9-point, the main path's three launches)."""
    from fluidsolver_tpu_torch.poisson import cuda_rap

    op = random_operator(*shape, seed=13, dtype=dtype, device=device)
    out = []
    for _ in range(above_tail_levels(shape)):
        out.append(op)
        op = cuda_rap.fused_rap_twin(op)[1]
    return out


def rap_limit_operators(dtype, device):
    """Operators at the limits of fused_rap's tiling: fine levels of 13 x 9
    (a coarse level of 7 x 5, smaller than one tile), 37 x 29 (19 x 15) and
    389 x 277 (195 x 139, sides a multiple of no tile), each 5-point and
    9-point (the Galerkin coarse operator of a level twice as fine). Yields
    (name, operator)."""
    from fluidsolver_tpu_torch.poisson import cuda_rap

    for n, m in ((13, 9), (37, 29), (389, 277)):
        yield f"{n}x{m} 5-point", random_operator(n, m, seed=31, dtype=dtype, device=device)
        fine = random_operator(2 * n - 1, 2 * m - 1, seed=37, dtype=dtype, device=device)
        yield f"{n}x{m} 9-point", cuda_rap.fused_rap_twin(fine)[1]


def rap_limits_phase(device, errors: Errors) -> None:
    """fused_rap against its twin on rap_limit_operators, f64 at phase 3's
    tolerances, f32 at the relative 1e-5 (bitwise logged)."""
    from fluidsolver_tpu_torch.poisson import cuda_rap

    for dtype in (torch.float64, torch.float32):
        bitwise = []
        for name, op in rap_limit_operators(dtype, device):
            trk, ck = cuda_rap.fused_rap_cuda(op)
            trt, ct = cuda_rap.fused_rap_twin(op)
            got, want = fields_of(trk) + fields_of(ck), fields_of(trt) + fields_of(ct)
            errors.compare("fused_rap", got, want, dtype, 1e-13, 1e-11, False, f"{str(dtype)[6:]} {name}")
            bitwise.append(f"{name} {all(torch.equal(a, b) for a, b in zip(got, want))}")
        log(f"  {str(dtype)[6:]}: fused_rap agrees with its twin at the tiling's limits; bitwise: "
            + ", ".join(bitwise))


def rap_turns(device, old, new) -> None:
    """fused_rap of the kernel library ``old`` against ``new``: all 17
    output planes bitwise equal at every level of the 1026^2 and 1023 x 771
    boxes and on rap_limit_operators, f64 and f32; then both timed in turns
    (old, new, new, old) at the main path's three levels in f32."""
    for dtype in (torch.float64, torch.float32):
        cases = [(f"{shape[0]}x{shape[1]} level {tuple(op.aC.shape)}", op)
                 for shape in ((1026, 1026), (1023, 771)) for op in rap_levels(shape, dtype, device)]
        for name, op in cases + list(rap_limit_operators(dtype, device)):
            require(all(torch.equal(a, b) for a, b in zip(fused_rap_with(old, op), fused_rap_with(new, op))),
                    f"fused_rap {str(dtype)[6:]} {name}: the two libraries' outputs differ")
        log(f"  {str(dtype)[6:]}: fused_rap's 17 planes bitwise equal to the parent's at {len(cases)} levels of the "
            "1026^2 and 1023x771 boxes and at the tiling's 6 limit levels")
    total = [0.0] * 4
    for op in rap_levels((1026, 1026), torch.float32, device):
        ms = [time_ms(lambda: fused_rap_with(lib, op), 20, kernel=True) for lib in (old, new, new, old)]
        total = [a + b for a, b in zip(total, ms)]
        n, m = op.aC.shape
        log(f"  fused_rap at {n}x{m} (f32), device ms in turns: parent {ms[0]:.4f}, this {ms[1]:.4f}, "
            f"this {ms[2]:.4f}, parent {ms[3]:.4f}; this / parent = {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}")
    log(f"  fused_rap, the three bench launches summed in turns: this {(total[1] + total[2]) / 2:.4f} ms, parent "
        f"{(total[0] + total[3]) / 2:.4f} ms; this / parent = {(total[1] + total[2]) / (total[0] + total[3]):.4f}")


def rap_report_phase(device, parent) -> None:
    """fused_rap's time and bound at each of the main path's three levels
    (f32); with ``parent``, the parent's kernel held bitwise to this one's
    and timed in turns (rap_turns)."""
    from fluidsolver_tpu_torch.poisson import cuda_rap

    rows = []
    for op in rap_levels((1026, 1026), torch.float32, device):
        n, m = op.aC.shape
        rows.append((f"{n}x{m}", time_ms(lambda: cuda_rap.fused_rap_cuda(op), 20, kernel=True), *rap_bound(op)))
    log("  fused_rap at the bench's three levels (f32, device ms / bound ms): "
        + "; ".join(f"{name} {t:.4f} / {bt:.4f} ({by})" for name, t, bt, by in rows)
        + f"; sum {sum(r[1] for r in rows):.4f} / {sum(r[2] for r in rows):.4f}")
    if parent is not None:
        rap_turns(device, parent_lib(parent), None)


@functools.cache
def parent_lib(parent: str) -> ctypes.CDLL:
    """The kernel library of another checkout ``parent`` (e.g. the parent
    commit unpacked by git archive), built from its csrc into _build/parent
    and bound like this commit's."""
    return checkout_lib(parent, "parent")


def load_library(so) -> ctypes.CDLL:
    """A kernel library built from another checkout's csrc, bound with this
    commit's signatures."""
    from fluidsolver_tpu_torch.poisson import _kernels

    lib = ctypes.CDLL(str(so))
    for name, argtypes in _kernels._SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is None:  # a measurement probe the other checkout does not have
            continue
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@contextlib.contextmanager
def kernel_library(lib):
    """Route the port's wrappers through ``lib`` (another checkout's build;
    None: this commit's) while the block runs."""
    from fluidsolver_tpu_torch.poisson import _kernels

    saved = _kernels.lib
    if lib is not None:
        _kernels.lib = lambda: lib
    try:
        yield
    finally:
        _kernels.lib = saved


def tail_cycle_with(lib, pack, b, n_pre: int, n_post: int):
    """cuda_tail.tail_cycle_cuda through the library ``lib`` (another
    checkout's build, for an A/B run in one process; None: this commit's)."""
    from fluidsolver_tpu_torch.poisson import cuda_tail

    with kernel_library(lib):
        return cuda_tail.tail_cycle_cuda(pack, b, n_pre, n_post)


def tail_setup_with(lib, op, n_levels: int):
    """cuda_tail.build_tail_pack_cuda through the library ``lib`` (None:
    this commit's)."""
    from fluidsolver_tpu_torch.poisson import cuda_tail

    with kernel_library(lib):
        return cuda_tail.build_tail_pack_cuda(op, n_levels)


def bench_tail(dtype, device) -> tuple:
    """The main path's tail: the random-jump operator of the 1026^2 box
    coarsened by fused_rap_twin down to the level where the tail starts
    (129^2, 5 levels); (operator, levels)."""
    from fluidsolver_tpu_torch.poisson import boxmg, cuda_rap

    op = random_operator(1026, 1026, seed=13, dtype=dtype, device=device)
    level = 0
    while not boxmg.tail_fits(tuple(op.aC.shape), boxmg._remaining_depth(tuple(op.aC.shape), level)):
        op = cuda_rap.fused_rap_twin(op)[1]
        level += 1
    return op, boxmg._remaining_depth(tuple(op.aC.shape), level)


def domain_tails(dtype, device):
    """Tails across tail_fits' domain: a 160 x 160 tail of 6 levels
    (9-point), a 66 x 66 tail of 4 levels with a 5-point finest operator
    (lid_driven(64) and the golden drop), an odd 129 x 97 tail of 5 levels
    (9-point). Yields (name, operator, levels)."""
    from fluidsolver_tpu_torch.poisson import cuda_rap

    for name, fine, coarsen, n_levels in (("160x160", (319, 319), True, 6), ("66x66 5-point", (66, 66), False, 4),
                                         ("129x97", (257, 193), True, 5)):
        op = random_operator(*fine, seed=17, dtype=dtype, device=device)
        yield name, cuda_rap.fused_rap_twin(op)[1] if coarsen else op, n_levels


def setup_barriers(shapes) -> tuple:
    """(cluster barriers, block barriers) of one csrc/tail.cu setup: each
    transfer has a block barrier between its weights and its Galerkin
    product and ends in a cluster barrier unless it is the last."""
    return len(shapes) - 2, len(shapes) - 1


def tail_setup_turns(device, old, new) -> None:
    """tail_setup of the kernel library ``old`` against ``new``: the pack
    bitwise equal at the bench tail and the domain tails, f64 and f32; then
    both timed in turns (old, new, new, old) at the bench tail in f32."""
    for dtype in (torch.float64, torch.float32):
        op, n_rem = bench_tail(dtype, device)
        for name, op_t, n_levels in [("bench", op, n_rem)] + list(domain_tails(dtype, device)):
            want, got = tail_setup_with(old, op_t, n_levels), tail_setup_with(new, op_t, n_levels)
            require(torch.equal(want.buf, got.buf),
                    f"tail_setup {str(dtype)[6:]} {name} tail: the two libraries' packs differ")
        log(f"  {str(dtype)[6:]}: tail_setup's pack bitwise equal to the parent's at the bench (129x129, 5 levels), "
            "160x160 (6 levels), 66x66 5-point and 129x97 tails")
    op, n_rem = bench_tail(torch.float32, device)
    ms = [time_ms(lambda: tail_setup_with(lib, op, n_rem), 50, kernel=True) for lib in (old, new, new, old)]
    log(f"  tail_setup at 129x129 (5 levels, f32), device ms in turns: parent {ms[0]:.4f}, this {ms[1]:.4f}, "
        f"this {ms[2]:.4f}, parent {ms[3]:.4f}; this / parent = {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}")


def tail_level_split(op, n_rem: int, device, lib=None) -> list:
    """tail_cycle V(2,2) on the tails that start at each level of the tail
    of ``op`` (each built by build_tail_pack_twin from that level's
    operator), through ``lib`` (default: this checkout's kernel): [(start
    shape, levels, device ms)]. Successive differences are the levels'
    shares of the whole tail's time."""
    from fluidsolver_tpu_torch.poisson import cuda_tail

    pt = cuda_tail.build_tail_pack_twin(op, n_rem)
    out = []
    for k in range(n_rem - 1):
        pk = pt if k == 0 else cuda_tail.build_tail_pack_twin(pt.ops[k], n_rem - k)
        b = random_field(pk.shapes[0], 800 + k, op.aC.dtype, device)
        out.append((pk.shapes[0], n_rem - k, time_ms(lambda: tail_cycle_with(lib, pk, b, 2, 2), 50, kernel=True)))
    return out


def log_split(who: str, split: list) -> None:
    shares = [(s, n, t - (split[k + 1][2] if k + 1 < len(split) else 0.0)) for k, (s, n, t) in enumerate(split)]
    log(f"  {who} tail_cycle per-level split (f32 V(2,2), device ms): "
        + "; ".join(f"tail from {s[0]}x{s[1]} ({n} levels) {t:.4f}" for s, n, t in split))
    log("    level shares (ms): " + "; ".join(
        f"{s[0]}x{s[1]}{' and coarser' if n == 2 else ''} {t:.4f}" for s, n, t in shares))


def barrier_us(device, n_blocks: int, n_threads: int) -> float:
    """Device time in us of one empty barrier in a cluster of ``n_blocks``
    blocks of 1024 threads: of the whole cluster (``n_threads`` = 0), or a
    named barrier of each block's first ``n_threads`` threads. A launch of
    2000 barriers less a launch of none."""
    from fluidsolver_tpu_torch.poisson import _kernels

    lib, stream = _kernels.lib(), _kernels.stream(device)

    def run(n):
        rc = lib.fs_sync_probe(n_blocks, n, n_threads, stream)
        require(rc == 0, f"the barrier probe did not launch: cudaError {rc}")

    n = 2000
    return (time_ms(lambda: run(n), 10, kernel=True) - time_ms(lambda: run(0), 10, kernel=True)) / n * 1e3


def cluster_launch_ms(device) -> float:
    """Device time in ms of an empty launch of a cluster of 8 blocks of 1024
    threads, back to back."""
    from fluidsolver_tpu_torch.poisson import _kernels

    lib, stream = _kernels.lib(), _kernels.stream(device)
    return time_ms(lambda: lib.fs_sync_probe(8, 0, 0, stream), 50, kernel=True)


def tail_barriers(shapes, n_pre: int, n_post: int) -> tuple:
    """(cluster barriers, block barriers, named barriers of the coarsest
    level's warps) of one csrc/tail.cu cycle: levels of more than 33^2
    points share the cluster (each half-step, residual, restriction and
    prolongation ends in a cluster barrier), the rest live in block 0 (each
    half-step, residual, restriction and prolongation, and each smoothing
    pass, ends in a block barrier; the coarsest level's half-steps in a
    named barrier of its warps)."""
    nl = len(shapes)
    nc = next((d for d, (n, m) in enumerate(shapes) if n * m <= 33 * 33), nl)
    down = min(nc, nl - 1)
    cluster = sum(2 * n_pre + 1 + (d + 1 < nc) for d in range(down)) + down * (1 + 2 * n_post)
    if nc == nl:
        return cluster + 4 * 16, 0, 0
    block = 1 + (nc > 0) + (nl - 1 - nc) * (2 * n_pre + 2 * n_post + 5) + 1
    return cluster + (nc > 0), block, 4 * 16


def tail_report_phase(device, tail_start: dict, parent) -> None:
    """The per-level split of tail_cycle at the main path's tail and its
    dependency floors, and tail_setup's; with ``parent`` (a checkout of
    another commit), that commit's tail_setup held bitwise to this one's
    (tail_setup_turns), and its tail_cycle split, both kernels timed in
    turns (parent, this, this, parent) on the same inputs."""
    from fluidsolver_tpu_torch.poisson import cuda_tail

    op, n_rem, b = tail_start["op"], tail_start["n_rem"], tail_start["b"]
    log_split("this commit's", tail_level_split(op, n_rem, device))
    shapes = cuda_tail.level_shapes(tuple(op.aC.shape), n_rem)
    nc, nb, nw = tail_barriers(shapes, 2, 2)
    n_warps = -(-shapes[-1][0] * shapes[-1][1] // 32) * 32
    b8, b1, bw = barrier_us(device, 8, 0), barrier_us(device, 1, 1024), barrier_us(device, 1, n_warps)
    log(f"  empty barrier: cluster of 8 x 1024 threads {b8:.4f} us, block of 1024 threads {b1:.4f} us, "
        f"named barrier of {n_warps} threads {bw:.4f} us; floors: 113 phases (the one-block kernel's) x the "
        f"cluster barrier = {113 * b8 / 1e3:.4f} ms; this kernel's {nc} cluster + {nb} block + {nw} named "
        f"barriers = {(nc * b8 + nb * b1 + nw * bw) / 1e3:.4f} ms")
    sc, sb = setup_barriers(shapes)
    launch = cluster_launch_ms(device)
    log(f"  tail_setup's dependency floor: an empty launch of a cluster of 8 x 1024 threads {launch:.4f} ms + "
        f"{sc} cluster + {sb} block barriers = {launch + (sc * b8 + sb * b1) / 1e3:.4f} ms (and "
        f"{2 * (len(shapes) - 1)} dependent rounds of loads, not measured)")
    if parent is None:
        return
    plib = parent_lib(parent)
    tail_setup_turns(device, plib, None)
    pt = cuda_tail.build_tail_pack_twin(op, n_rem)
    xo, xn = tail_cycle_with(plib, pt, b, 2, 2), cuda_tail.tail_cycle_cuda(pt, b, 2, 2)
    require(torch.equal(xo, xn), "the parent's tail_cycle and this commit's differ")
    runs = [("parent", plib), ("this", None), ("this", None), ("parent", plib)]
    ms = [time_ms(lambda: tail_cycle_with(lib, pt, b, 2, 2), 50, kernel=True) for _, lib in runs]
    log(f"  tail_cycle at {shapes[0][0]}x{shapes[0][1]} ({n_rem} levels, f32 V(2,2)), device ms in turns: "
        + ", ".join(f"{w} {t:.4f}" for (w, _), t in zip(runs, ms))
        + f"; this / parent = {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}")
    log_split("the parent's", tail_level_split(op, n_rem, device, plib))


def tail_domain_phase(device, errors: Errors) -> None:
    """tail_setup and tail_cycle against their twins on domain_tails, f32
    and f64, V(2,2) and V(1,1); tail_cycle at rtol 1e-12, bitwise in f32;
    tail_setup called twice bitwise equal."""
    from fluidsolver_tpu_torch.poisson import cuda_tail

    for dtype in (torch.float64, torch.float32):
        for name, op, n_levels in domain_tails(dtype, device):
            tag = f"{str(dtype)[6:]} {name} ({n_levels} levels)"
            pk = cuda_tail.build_tail_pack_cuda(op, n_levels)
            pt = cuda_tail.build_tail_pack_twin(op, n_levels)
            errors.compare("tail_setup", [pk.buf], [pt.buf], dtype, 1e-10, 1e-10 * float(pt.buf.abs().max()),
                           False, f"{tag} pack")
            require(torch.equal(pk.buf, cuda_tail.build_tail_pack_cuda(op, n_levels).buf),
                    f"tail_setup {tag}: two calls differ")
            b = random_field(tuple(op.aC.shape), 900, dtype, device)
            for pre_post in ((2, 2), (1, 1)):
                xk = cuda_tail.tail_cycle_cuda(pt, b, *pre_post)
                xt = cuda_tail.tail_cycle_twin(pt, b, *pre_post)
                errors.compare("tail_cycle", [xk], [xt], dtype, 1e-12, 1e-12 * float(xt.abs().max()), False,
                               f"{tag} V{pre_post}")
                require(dtype == torch.float64 or torch.equal(xk, xt), f"tail_cycle {tag} V{pre_post}: not bitwise")
            log(f"  {tag}: tail_setup and tail_cycle (V(2,2), V(1,1)) agree"
                + (", tail_cycle bitwise" if dtype == torch.float32 else ""))


# ---- phase 3: fused_smooth --------------------------------------------------
def check_smooth(errors: Errors, op, b, kw, main: bool, what: str) -> None:
    """fused_smooth's kernel against its twin on one variant: bitwise in
    f32; f64 within 1e-12 absolute (the restricted residual 1e-11 absolute
    and relative)."""
    from fluidsolver_tpu_torch.poisson import cuda_vcycle

    got = cuda_vcycle.fused_smooth_cuda(op, b, **kw)
    want = cuda_vcycle.fused_smooth_twin(op, b, **kw)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    restrict = kw.get("restrict", False)
    errors.compare("fused_smooth", got, want, b.dtype, 1e-11 if restrict else 0.0, 1e-11 if restrict else 1e-12,
                   main, what)
    require(b.dtype == torch.float64 or all(torch.equal(g, w) for g, w in zip(got, want)),
            f"fused_smooth {what}: not bitwise in f32")


def smooth_bound(op, kw) -> tuple:
    """fused_smooth's bound for the variant ``kw``: the operator's planes,
    b, x0, the weights and ec read once, x and the residual (fine or
    coarse) written once; per point 2 ncoef + 3 flops for each half-step of
    its colour, 2 ncoef for the residual and 6 for the prolongation, per
    coarse point 16 for the restriction."""
    from fluidsolver_tpu_torch.poisson import boxmg

    ncoef, dtype = len(boxmg.coefs(op)), op.aC.dtype
    n, m = op.aC.shape
    nm, ncm = n * m, ((n + 1) // 2) * ((m + 1) // 2)
    restrict, residual, ec = kw.get("restrict", False), kw.get("residual", False), kw.get("ec") is not None
    fine = ncoef + 1 + (kw.get("x0") is not None) + 1 + residual
    coarse = 8 * (restrict or ec) + restrict + ec
    flops = (len(kw["colors"]) * (2 * ncoef + 3) / 2 + 2 * ncoef * (restrict or residual) + 6 * ec) * nm \
        + 16 * restrict * ncm
    return bound(itemsize(dtype) * (fine * nm + coarse * ncm), flops, dtype)


def smooth_variants(tr, x0, ec, n_pre: int, n_post: int) -> dict:
    """The two launches of a V(n_pre, n_post) cycle on a level above the
    tail (boxmg.v_cycle): the restriction phase from zero and the
    prolongation phase from x0."""
    return {"restrict": dict(colors=(True, False) * n_pre, tr=tr, restrict=True),
            "ec": dict(x0=x0, colors=(False, True) * n_post, tr=tr, ec=ec)}


def bench_smooth_launches(device, dtype=torch.float32) -> list:
    """The six fused_smooth launches of one bench V(2,2) cycle: restrict and
    ec on each level above the tail of the 1026^2 box (the random jump
    operator and its Galerkin coarse operators): [(name, op, b, kw)]."""
    from fluidsolver_tpu_torch.poisson import cuda_rap

    op = random_operator(1026, 1026, seed=13, dtype=dtype, device=device)
    out = []
    for level in range(above_tail_levels((1026, 1026))):
        tr, coarse = cuda_rap.fused_rap_twin(op)
        shape = tuple(op.aC.shape)
        b = random_field(shape, 100 + level, dtype, device)
        x0 = random_field(shape, 200 + level, dtype, device)
        ec = random_field(tuple(tr.pW.shape), 300 + level, dtype, device)
        for kind, kw in smooth_variants(tr, x0, ec, 2, 2).items():
            out.append((f"{kind} {shape[0]}x{shape[1]}", op, b, kw))
        op = coarse
    return out


def smooth_limits_phase(device, errors: Errors) -> None:
    """fused_smooth against its twin at the limits of its tiling: a 5-point
    level whose sides are a multiple of no tile (389 x 277), its 9-point
    Galerkin coarse level (195 x 139), and a 5-point level smaller than a
    tile (37 x 29); V(1,1) (2 half-steps), the deepest phases the wrapper
    admits (6 half-steps + restriction, 7 + residual, 8 plain from x0 and
    with the ec prologue: a halo of MAX_HALO) and the coarsest level's
    sweep pair (red, black, black, red). Bitwise in f32; f64 as phase 3."""
    from fluidsolver_tpu_torch.poisson import cuda_rap

    for dtype in (torch.float64, torch.float32):
        fine = random_operator(389, 277, seed=19, dtype=dtype, device=device)
        for name, op in (("389x277 5-point", fine), ("195x139 9-point", cuda_rap.fused_rap_twin(fine)[1]),
                         ("37x29 5-point", random_operator(37, 29, seed=23, dtype=dtype, device=device))):
            tr = cuda_rap.fused_rap_twin(op)[0]
            shape = tuple(op.aC.shape)
            b, x0 = random_field(shape, 400, dtype, device), random_field(shape, 401, dtype, device)
            ec = random_field(tuple(tr.pW.shape), 402, dtype, device)
            cases = {f"V(1,1) {k}": kw for k, kw in smooth_variants(tr, x0, ec, 1, 1).items()}
            cases.update({
                "6 half-steps + restrict": dict(colors=(True, False) * 3, tr=tr, restrict=True),
                "7 half-steps + residual": dict(x0=x0, colors=(False, True) * 3 + (False,), residual=True),
                "8 half-steps plain": dict(x0=x0, colors=(True, False) * 4),
                "8 half-steps ec": dict(x0=x0, colors=(False, True) * 4, tr=tr, ec=ec),
                "sweep pair": dict(x0=x0, colors=(True, False, False, True)),
            })
            for what, kw in cases.items():
                check_smooth(errors, op, b, kw, False, f"{str(dtype)[6:]} {name} {what}")
            log(f"  {str(dtype)[6:]} {name}: fused_smooth agrees on {len(cases)} limit cases"
                + (", bitwise" if dtype == torch.float32 else ""))


def smooth_report_phase(device, parent) -> None:
    """fused_smooth's six launches of one bench V-cycle, each with its time
    and bound; the 1026^2 restrict launch split into its half-steps (the
    plain variant), the residual and the restriction; with ``parent``, the
    parent's kernel on the same inputs, bitwise against this one's and
    timed in turns (parent, this, this, parent) at all six launches."""
    from fluidsolver_tpu_torch.poisson import cuda_vcycle

    def timed(op, b, kw, lib=None):
        with kernel_library(lib):
            return time_ms(lambda: cuda_vcycle.fused_smooth_cuda(op, b, **kw), 50, kernel=True)

    from fluidsolver_tpu_torch.poisson import _kernels

    lib, stream = _kernels.lib(), _kernels.stream(device)
    empty = time_ms(lambda: lib.fs_sync_probe(1, 0, 1, stream), 50, kernel=True)
    log(f"  an empty one-block launch, back to back (the launch floor): {empty:.4f} ms")
    launches = bench_smooth_launches(device)
    rows = [(name, timed(op, b, kw), *smooth_bound(op, kw)) for name, op, b, kw in launches]
    log("  fused_smooth, the six launches of one bench V(2,2) cycle (f32, device ms / bound ms): "
        + "; ".join(f"{name} {t:.4f} / {bt:.4f} ({by})" for name, t, bt, by in rows)
        + f"; sum {sum(r[1] for r in rows):.4f} / {sum(r[2] for r in rows):.4f}")
    _, op, b, kw = launches[0]
    half = dict(colors=kw["colors"])
    t_plain, t_res = timed(op, b, half), timed(op, b, dict(half, residual=True))
    log(f"  fused_smooth {launches[0][0]} split (device ms): the 4 half-steps (plain variant) {t_plain:.4f}, "
        f"+ residual {t_res:.4f}, + restriction {rows[0][1]:.4f}")
    if parent is None:
        return
    plib = parent_lib(parent)
    ratios = []
    for name, op, b, kw in launches:
        with kernel_library(plib):
            old = cuda_vcycle.fused_smooth_cuda(op, b, **kw)
        new = cuda_vcycle.fused_smooth_cuda(op, b, **kw)
        old, new = (old if isinstance(old, tuple) else (old,)), (new if isinstance(new, tuple) else (new,))
        require(all(torch.equal(o, w) for o, w in zip(old, new)), f"the parent's fused_smooth and this commit's "
                f"differ at {name}")
        ms = [timed(op, b, kw, lib) for lib in (plib, None, None, plib)]
        ratios.append(ms)
        log(f"  fused_smooth {name}, device ms in turns: parent {ms[0]:.4f}, this {ms[1]:.4f}, this {ms[2]:.4f}, "
            f"parent {ms[3]:.4f}; this / parent = {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}")
    this, par = sum(m[1] + m[2] for m in ratios) / 2, sum(m[0] + m[3] for m in ratios) / 2
    log(f"  fused_smooth, six launches summed in turns: this {this:.4f} ms, parent {par:.4f} ms; "
        f"this / parent = {this / par:.4f} (the parent's kernel bitwise equal at all six)")


# ---- phase 3b --------------------------------------------------------------
def fit_error(vf, nx, ny, d, dx, dy):
    """ELVIRA's objective of the planes (nx, ny, d) on the interior, in f64."""
    from fluidsolver_tpu_torch.vof import plic

    vf, nx, ny, d = (t.double() for t in (vf, nx, ny, d))
    c = [plic.shift(t, 0, 0) for t in (nx, ny, d)]
    err = torch.zeros_like(c[0])
    for di, dj in plic.NEIGHBOR_OFFSETS:
        pred = plic.area_fraction(c[0], c[1], c[2] - (c[0] * di * dx + c[1] * dj * dy), dx, dy)
        err = err + (pred - plic.shift(vf, di, dj)) ** 2
    return err


def neighbourhood_cells(mask) -> int:
    """Cells in the union of the 3x3 neighbourhoods of ``mask``'s cells."""
    grown = torch.nn.functional.max_pool2d(mask[None, None].float(), 3, 1, 1)[0, 0]
    return int(grown.sum())


def overlap_flops(args, n_active: int) -> int:
    """Floating-point operations of csrc/overlap.cu's clip loop on these
    lanes' polygons, counted where the result needs them: per active lane
    the start polygon's shoelace (4 per vertex + 1) and the 9-term sum; per
    neighbour above the cutoff, 4 per vertex entering each of the 5 clips
    (the side test), 8 per crossing (a difference, a division and two
    interpolations of 3) and the final shoelace (4 per vertex + 1). The
    vertex and crossing counts come from the plain clip chain."""
    from fluidsolver_tpu_torch.constants import vf_cutoffs
    from fluidsolver_tpu_torch.vof import advect, cuda_advect
    from fluidsolver_tpu_torch.vof.plic import NEIGHBOR_OFFSETS

    slots_x, slots_y, vf, rec, iig, jjg, dx, dy = args
    vx, vy, n = advect.pad_slots(slots_x, slots_y)
    gathered = cuda_advect.gather_neighbourhood(vf, rec, iig, jjg)
    vf_nb, mixed, pnx, pny, pd = gathered[0], gathered[1] > 0.5, gathered[2], gathered[3], gathered[4]
    lo, _ = vf_cutoffs(vf.dtype)
    need = (vf_nb > lo) & (torch.arange(vf_nb.shape[1], device=vf.device) < n_active)
    offs = torch.tensor(NEIGHBOR_OFFSETS, dtype=vf.dtype, device=vf.device)
    x_lo = (offs[:, 0] * dx)[:, None].expand_as(vf_nb)
    y_lo = (offs[:, 1] * dy)[:, None].expand_as(vf_nb)
    ones, zeros = torch.ones_like(x_lo), torch.zeros_like(x_lo)
    planes = ((-ones, zeros, -x_lo), (ones, zeros, x_lo + dx), (zeros, -ones, -y_lo), (zeros, ones, y_lo + dy),
              (torch.where(mixed, pnx, zeros), torch.where(mixed, pny, zeros),
               torch.where(mixed, pd + pnx * x_lo + pny * y_lo, ones)))
    vx, vy, n = vx.expand(9, *vx.shape), vy.expand(9, *vy.shape), n.expand(9, *n.shape)
    flops = 0
    for a, b, c in planes:
        nn = n.clamp(max=advect.K)
        d = a[..., None] * vx + b[..., None] * vy - c[..., None]
        inside = ((d <= 0.0) & (torch.arange(advect.K, device=vf.device) < nn[..., None])).sum(-1)
        vx, vy, n = advect.clip_halfplane(vx, vy, n, a, b, c)
        flops += int(torch.where(need, 4 * nn + 8 * (n - inside), 0).sum())
    flops += int(torch.where(need, 4 * n.clamp(max=advect.K) + 1, 0).sum())
    return flops + n_active * (4 * slots_x.shape[0] + 1 + 9)


def check_elvira(errors: Errors, vf, dx: float, dy: float, main: bool, tag: str):
    """elvira against its twin on ``vf``: valid exactly; the planes to
    rounding (f64: 1e-10 relative and 1e-12 absolute; f32: the relative
    1e-5) on every cell of the main path's field; elsewhere a cell may
    differ only at a near-tie, where both winners fit the neighbourhood
    equally well. Returns (the twin's Plic, cells at a near-tie)."""
    from fluidsolver_tpu_torch.vof import cuda_elvira

    dtype = vf.dtype
    rk = cuda_elvira.elvira_cuda(vf, dx, dy)
    rt = cuda_elvira.elvira_twin(vf, dx, dy)
    require(torch.equal(rk.valid, rt.valid), f"elvira {tag}: valid masks differ")
    tol = (lambda w: 1e-12 + 1e-10 * w.abs()) if dtype == torch.float64 else \
        (lambda w: F32_RTOL * max(float(w.abs().max()), 1e-30))
    off = torch.zeros_like(rt.valid)
    for a, b in ((rk.nx, rt.nx), (rk.ny, rt.ny), (rk.d, rt.d)):
        off |= (a - b).abs() > tol(b)
    n_off = int(off.sum())
    require(not (main and n_off), f"elvira {tag}: {n_off} cells differ from the twin")
    if n_off:
        ek = fit_error(vf, rk.nx, rk.ny, rk.d, dx, dy)
        et = fit_error(vf, rt.nx, rt.ny, rt.d, dx, dy)
        o = off[1:-1, 1:-1]
        gap = float(((ek - et).abs()[o] / (et[o].abs() + 1e-12)).max())
        require(gap <= (1e-6 if dtype == torch.float64 else 1e-5),
                f"elvira {tag}: {n_off} cells differ and are not near-ties (fit gap {gap:.3e})")
    errors.compare("elvira", [rk.nx, rk.ny, rk.d], [rt.nx, rt.ny, rt.d], dtype, 1e-10, 1e-12, main, tag, mask=~off)
    return rt, n_off


# csrc/elvira.cu's tile (kTileY x kTileX cells, one block each)
ELVIRA_TILE = (8, 32)


def elvira_limit_fields() -> list:
    """Fields of 259 x 193 cells (sides a multiple of no tile) at the limits
    of elvira's per-block list: every cell mixed (seeded noise in (0.02,
    0.98), so every block's list is full), no mixed cell (a 0 / 1 step), a
    single mixed cell (0.4 in the step), and a mixed cell with a NaN
    neighbour (all 12 candidate errors NaN: it keeps (0, 1, 0), valid).
    Returns [(name, dx, dy, vf)], vf in numpy f64."""
    n, m = 259, 193
    dx, dy = 1.0 / (n - 2), 1.3 / (m - 2)
    step = np.where(np.arange(n)[:, None] < n // 2, 0.0, 1.0) * np.ones((n, m))
    single = step.copy()
    single[100, 77] = 0.4
    nan = single.copy()
    nan[101, 78] = np.nan
    full = np.random.default_rng(29).uniform(0.02, 0.98, (n, m))
    return [("every cell mixed", dx, dy, full), ("no mixed cell", dx, dy, step),
            ("one mixed cell", dx, dy, single), ("a NaN neighbour", dx, dy, nan)]


def elvira_limits_phase(device, errors: Errors) -> None:
    """elvira against its twin (check_elvira) on elvira_limit_fields, f64
    and f32; the cell with a NaN neighbour must come out (0, 1, 0), valid."""
    from fluidsolver_tpu_torch.vof import cuda_elvira

    for dtype in (torch.float64, torch.float32):
        notes = []
        for name, dx, dy, vf_np in elvira_limit_fields():
            vf = torch.as_tensor(vf_np, dtype=dtype, device=device)
            rt, n_off = check_elvira(errors, vf, dx, dy, False, f"{str(dtype)[6:]} {name}")
            notes.append(f"{name}: {int(rt.valid.sum())} mixed, {n_off} near-ties")
            if name == "a NaN neighbour":
                rk = cuda_elvira.elvira_cuda(vf, dx, dy)
                cell = [float(t[100, 77]) for t in (rk.nx, rk.ny, rk.d)] + [bool(rk.valid[100, 77])]
                require(cell == [0.0, 1.0, 0.0, True], f"elvira {str(dtype)[6:]}: the cell with a NaN neighbour "
                        f"gives {cell}")
        log(f"  {str(dtype)[6:]} limit fields (259x193): elvira agrees with its twin; " + "; ".join(notes))


def elvira_with(lib, vf, dx: float, dy: float) -> list:
    """cuda_elvira.elvira_cuda through the library ``lib`` (None: this
    commit's): nx, ny, d and valid."""
    from fluidsolver_tpu_torch.vof import cuda_elvira

    with kernel_library(lib):
        r = cuda_elvira.elvira_cuda(vf, dx, dy)
    return [r.nx, r.ny, r.d, r.valid]


def elvira_fill_ms(lib, vf, dx: float, dy: float) -> float:
    """Device ms of ``lib``'s fill-only probe on ``vf``: elvira's launch
    with the fills written on every cell and no search (its memory floor)."""
    from fluidsolver_tpu_torch.constants import vf_cutoffs
    from fluidsolver_tpu_torch.poisson import _kernels

    n, m = vf.shape
    out = torch.empty((3, n, m), dtype=vf.dtype, device=vf.device)
    valid = torch.empty((n, m), dtype=torch.uint8, device=vf.device)
    lo, hi = vf_cutoffs(vf.dtype)
    stream = _kernels.stream(vf.device)

    def run():
        rc = lib.fs_elvira_fill_probe(_kernels.dtype_code(vf.dtype), vf.data_ptr(), n, m, float(dx), float(dy),
                                      lo, hi, out.data_ptr(), valid.data_ptr(), stream)
        require(rc == 0, f"the fill-only probe did not launch: cudaError {rc}")

    return time_ms(run, 50, kernel=True)


def mixed_census(valid, tile) -> tuple:
    """(mixed cells, tiles of ``tile`` = (rows, columns) cells that hold
    one, 32-cell row segments that hold one: the warps of a 32-wide tile
    that run a search)."""
    v = valid.cpu().numpy()
    n, m = v.shape

    def occupied(th, tw):
        pad = np.zeros((-(-n // th) * th, -(-m // tw) * tw), bool)
        pad[:n, :m] = v
        return int(pad.reshape(pad.shape[0] // th, th, pad.shape[1] // tw, tw).any(axis=(1, 3)).sum())

    return int(v.sum()), occupied(*tile), occupied(1, 32)


def elvira_turns(device, old, new, vf_bench: np.ndarray, g_bench) -> None:
    """elvira of the kernel library ``old`` against ``new``: nx, ny, d and
    valid bitwise equal on the bench drop, the 25-drop 1023 x 771 box and
    elvira_limit_fields, f64 and f32; then both timed in turns (old, new,
    new, old) on the bench drop in f32, beside ``new``'s fill-only floor."""
    from fluidsolver_tpu_torch.poisson import _kernels

    g_odd, vf_odd = drops_vf(1023, 771, 25, seed=5)
    fields = [("bench drop", g_bench.dx, g_bench.dy, vf_bench), ("25 drops 1023x771", g_odd.dx, g_odd.dy, vf_odd)]
    for dtype in (torch.float64, torch.float32):
        for name, dx, dy, vf_np in fields + elvira_limit_fields():
            vf = torch.as_tensor(vf_np, dtype=dtype, device=device)
            want, got = elvira_with(old, vf, dx, dy), elvira_with(new, vf, dx, dy)
            require(all(torch.equal(a, b) for a, b in zip(want, got)),
                    f"elvira {str(dtype)[6:]} {name}: the two libraries' nx, ny, d or valid differ")
        log(f"  {str(dtype)[6:]}: elvira's nx, ny, d and valid bitwise equal to the parent's on the bench drop, "
            "the 25-drop box and the four limit fields")
    vf = torch.as_tensor(vf_bench, dtype=torch.float32, device=device)
    dx, dy = g_bench.dx, g_bench.dy
    ms = [time_ms(lambda: elvira_with(lib, vf, dx, dy), 50, kernel=True) for lib in (old, new, new, old)]
    fill = elvira_fill_ms(new or _kernels.lib(), vf, dx, dy)
    log(f"  elvira on the bench drop (1026x1026 f32), device ms in turns: parent {ms[0]:.4f}, this {ms[1]:.4f}, "
        f"this {ms[2]:.4f}, parent {ms[3]:.4f}; this / parent = {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}; "
        f"fill-only floor {fill:.4f}")


def elvira_report_phase(device, vf_bench: np.ndarray, g_bench, parent) -> None:
    """Where elvira's search lies on the bench drop (f32): the mixed cells,
    the tiles and 32-cell row segments that hold them; the kernel's time
    beside its fill-only floor; with ``parent``, the parent's kernel held
    bitwise to this one's and timed in turns (elvira_turns)."""
    from fluidsolver_tpu_torch.poisson import _kernels
    from fluidsolver_tpu_torch.vof import cuda_elvira

    vf = torch.as_tensor(vf_bench, dtype=torch.float32, device=device)
    dx, dy = g_bench.dx, g_bench.dy
    valid = cuda_elvira.elvira_cuda(vf, dx, dy).valid
    n_mixed, tiles, rows = mixed_census(valid, ELVIRA_TILE)
    total = -(-vf.shape[0] // ELVIRA_TILE[0]) * -(-vf.shape[1] // ELVIRA_TILE[1])
    t = time_ms(lambda: cuda_elvira.elvira_cuda(vf, dx, dy), 50, kernel=True)
    fill = elvira_fill_ms(_kernels.lib(), vf, dx, dy)
    log(f"  elvira on the bench drop (1026x1026 f32): {n_mixed} mixed cells in {tiles} of {total} "
        f"{ELVIRA_TILE[0]}x{ELVIRA_TILE[1]} tiles and {rows} 32-cell row segments; kernel {t:.4f} ms, fill-only "
        f"floor {fill:.4f} ms, the search {t - fill:.4f} ms")
    if parent is not None:
        elvira_turns(device, parent_lib(parent), None, vf_bench, g_bench)


def ghost_ring_field() -> tuple:
    """A field of 259 x 193 cells with drops (r = 0.1) centred on each wall
    and on a corner, so that valid cells lie beside the ghost ring on every
    side. Returns (name, dx, dy, vf), vf in numpy f64."""
    n, m = 259, 193
    dx, dy = 1.0 / (n - 2), 1.3 / (m - 2)
    X, Y = np.meshgrid((np.arange(n) - 0.5) * dx, (np.arange(m) - 0.5) * dy, indexing="ij")
    phi = np.full(X.shape, np.inf)
    for cx, cy in ((0.0, 0.65), (1.0, 0.4), (0.5, 0.0), (0.3, 1.3), (1.0, 1.3)):
        phi = np.minimum(phi, np.hypot(X - cx, Y - cy) - 0.1)
    # a band about two cells deep, so that every side holds mixed cells
    return "valid cells beside the ghost ring", dx, dy, np.clip(0.5 - phi / (2 * dy), 0.0, 1.0)


def curvature_fields(vf_bench: np.ndarray, g_bench) -> list:
    """[(name, dx, dy, vf)]: the bench drop, the 25-drop 1023 x 771 box,
    elvira's four limit fields and ghost_ring_field."""
    g_odd, vf_odd = drops_vf(1023, 771, 25, seed=5)
    return [("bench drop", g_bench.dx, g_bench.dy, vf_bench), ("25 drops 1023x771", g_odd.dx, g_odd.dy, vf_odd),
            *elvira_limit_fields(), ghost_ring_field()]


def plic_planes(vf_np: np.ndarray, dx: float, dy: float, dtype, device) -> tuple:
    """(nx, ny, d, valid) of this commit's elvira on ``vf_np``: the inputs
    of curvature."""
    from fluidsolver_tpu_torch.vof import cuda_elvira

    r = cuda_elvira.elvira_cuda(torch.as_tensor(vf_np, dtype=dtype, device=device), dx, dy)
    return r.nx, r.ny, r.d, r.valid


def check_curvature(errors: Errors, planes, dx: float, dy: float, main: bool, tag: str):
    """curvature against its twin on ``planes`` (f64: 1e-10 relative and
    1e-12 of max |twin| absolute; f32: the relative 1e-5). Returns the
    kernel's curvature."""
    from fluidsolver_tpu_torch.vof import cuda_curvature

    ck = cuda_curvature.curvature_vm_cuda(*planes, dx, dy)
    ct = cuda_curvature.curvature_vm_twin(*planes, dx, dy)
    errors.compare("curvature", [ck], [ct], planes[0].dtype, 1e-10, 1e-12 * float(ct.abs().max()), main, tag)
    return ck


def curvature_limits_phase(device, errors: Errors) -> None:
    """curvature against its twin on elvira's limit fields and
    ghost_ring_field, f64 and f32: the lone mixed cell (fewer than two
    segments) must give 0, every cell must be 0 without a valid cell, and
    the ghost-ring field must hold valid cells in the first and last
    interior rows and columns."""
    for dtype in (torch.float64, torch.float32):
        notes = []
        for name, dx, dy, vf_np in [*elvira_limit_fields(), ghost_ring_field()]:
            planes = plic_planes(vf_np, dx, dy, dtype, device)
            ck = check_curvature(errors, planes, dx, dy, False, f"{str(dtype)[6:]} {name}")
            valid = planes[3]
            notes.append(f"{name}: {int(valid.sum())} valid, {int((ck != 0).sum())} nonzero")
            if name in ("no mixed cell", "one mixed cell"):
                require(not bool(ck.any()), f"curvature {str(dtype)[6:]} {name}: a nonzero curvature")
            if name == ghost_ring_field()[0]:
                edges = (valid[1, :], valid[-2, :], valid[:, 1], valid[:, -2])
                require(all(bool(e.any()) for e in edges) and not bool(valid[[0, -1], :].any()),
                        "the ghost-ring field has no valid cell on some side of the interior")
        log(f"  {str(dtype)[6:]} curvature limit fields (259x193): agrees with its twin; " + "; ".join(notes))


def curvature_with(lib, planes, dx: float, dy: float):
    """cuda_curvature.curvature_vm_cuda through the library ``lib`` (None:
    this commit's)."""
    from fluidsolver_tpu_torch.vof import cuda_curvature

    with kernel_library(lib):
        return cuda_curvature.curvature_vm_cuda(*planes, dx, dy)


def curvature_fill_ms(lib, planes, dx: float, dy: float) -> float:
    """Device ms of ``lib``'s fill-only probe: curvature's launch with 0
    written on every cell and no fit (its memory floor)."""
    from fluidsolver_tpu_torch.poisson import _kernels

    nx, ny, d, valid = planes
    n, m = nx.shape
    out = torch.empty_like(nx)
    stream = _kernels.stream(nx.device)

    def run():
        rc = lib.fs_curvature_fill_probe(_kernels.dtype_code(nx.dtype), nx.data_ptr(), ny.data_ptr(), d.data_ptr(),
                                         valid.data_ptr(), n, m, float(dx), float(dy), out.data_ptr(), stream)
        require(rc == 0, f"the curvature fill-only probe did not launch: cudaError {rc}")

    return time_ms(run, 50, kernel=True)


def curvature_turns(device, old, new, vf_bench: np.ndarray, g_bench) -> None:
    """curvature of the kernel library ``old`` against ``new``: bitwise
    equal on curvature_fields' planes, f64 and f32; then both timed in
    turns (old, new, new, old) on the bench drop in f32, beside ``new``'s
    fill-only floor."""
    from fluidsolver_tpu_torch.poisson import _kernels

    fields = curvature_fields(vf_bench, g_bench)
    for dtype in (torch.float64, torch.float32):
        for name, dx, dy, vf_np in fields:
            planes = plic_planes(vf_np, dx, dy, dtype, device)
            require(torch.equal(curvature_with(old, planes, dx, dy), curvature_with(new, planes, dx, dy)),
                    f"curvature {str(dtype)[6:]} {name}: the two libraries differ")
        log(f"  {str(dtype)[6:]}: curvature bitwise equal to the parent's on the bench drop, the 25-drop box, "
            "the four limit fields and the ghost-ring field")
    dx, dy = g_bench.dx, g_bench.dy
    planes = plic_planes(vf_bench, dx, dy, torch.float32, device)
    ms = [time_ms(lambda: curvature_with(lib, planes, dx, dy), 50, kernel=True) for lib in (old, new, new, old)]
    fill = curvature_fill_ms(new or _kernels.lib(), planes, dx, dy)
    log(f"  curvature on the bench drop (1026x1026 f32), device ms in turns: parent {ms[0]:.4f}, this {ms[1]:.4f}, "
        f"this {ms[2]:.4f}, parent {ms[3]:.4f}; this / parent = {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}; "
        f"fill-only floor {fill:.4f}")


def curvature_report_phase(device, vf_bench: np.ndarray, g_bench, parent) -> None:
    """curvature on the bench drop (f32): the valid cells and the tiles
    that hold them, the kernel's time beside its fill-only floor; with
    ``parent``, the parent's kernel held bitwise to this one's and timed in
    turns (curvature_turns)."""
    from fluidsolver_tpu_torch.poisson import _kernels
    from fluidsolver_tpu_torch.vof import cuda_curvature

    dx, dy = g_bench.dx, g_bench.dy
    planes = plic_planes(vf_bench, dx, dy, torch.float32, device)
    n_valid, tiles, _ = mixed_census(planes[3], ELVIRA_TILE)
    t = time_ms(lambda: cuda_curvature.curvature_vm_cuda(*planes, dx, dy), 50, kernel=True)
    fill = curvature_fill_ms(_kernels.lib(), planes, dx, dy)
    log(f"  curvature on the bench drop (1026x1026 f32): {n_valid} valid cells in {tiles} "
        f"{ELVIRA_TILE[0]}x{ELVIRA_TILE[1]} tiles; kernel {t:.4f} ms, fill-only floor {fill:.4f} ms, "
        f"the fit {t - fill:.4f} ms")
    if parent is not None:
        curvature_turns(device, parent_lib(parent), None, vf_bench, g_bench)


def corner_drop(g, vf_np: np.ndarray) -> np.ndarray:
    """``vf_np`` with a liquid drop (r = 0.05) over the box's last interior
    corner, so that the fill lanes, which gather that corner through clamped
    indices, find neighbours above the cutoff."""
    X, Y = np.meshgrid(g.xm, g.ym, indexing="ij")
    phi = np.hypot(X - g.xm[-2], Y - g.ym[-2]) - 0.05
    return np.maximum(vf_np, np.clip(0.5 - phi / g.dx, 0.0, 1.0))


def swirl_lanes(g, vf_np: np.ndarray, dtype, device, budget=None) -> tuple:
    """(overlap's arguments, active cells) of one advection of ``vf_np``
    through the swirl at CFL 0.5 with ``budget`` lanes (None: the default)."""
    from fluidsolver_tpu_torch.vof import advect, cuda_elvira

    vf = torch.as_tensor(vf_np, dtype=dtype, device=device)
    rec = cuda_elvira.elvira_cuda(vf, g.dx, g.dy)
    U, V, Ui, Vi = swirl_velocity(g, dtype, device)
    dt = torch.tensor(0.5 * g.dx, dtype=dtype, device=device)
    lanes = advect.prepare_lanes(vf, U, V, Ui, Vi, g, dt, budget or advect.default_max_active(g.nx, g.ny))
    return (lanes.slots_x, lanes.slots_y, vf, rec, lanes.iig, lanes.jjg, g.dx, g.dy), int(lanes.n_active)


def overlap_cases(device, dtype, vf_bench: np.ndarray, g_bench) -> list:
    """[(name, overlap's arguments, active cells)]: the swirl lanes of the
    bench drop and of the 25-drop 1023 x 771 box; on the box, budgets of
    half the active cells (every lane active, overflow) and of exactly the
    active cells (no fill lane); the box with a liquid drop over the corner
    that the fill lanes gather; a single lane of the bench drop."""
    g_odd, vf_odd = drops_vf(1023, 771, 25, seed=5)
    bench, n_bench = swirl_lanes(g_bench, vf_bench, dtype, device)
    box, n_box = swirl_lanes(g_odd, vf_odd, dtype, device)
    corner, n_corner = swirl_lanes(g_odd, corner_drop(g_odd, vf_odd), dtype, device)
    return [("bench drop", bench, n_bench), ("25 drops 1023x771", box, n_box),
            ("25 drops, budget n_active // 2", swirl_lanes(g_odd, vf_odd, dtype, device, n_box // 2)[0], n_box),
            ("25 drops, budget n_active", swirl_lanes(g_odd, vf_odd, dtype, device, n_box)[0], n_box),
            ("25 drops, a liquid corner", corner, n_corner),
            ("bench drop, one lane", swirl_lanes(g_bench, vf_bench, dtype, device, 1)[0], n_bench)]


def working_pairs(args) -> int:
    """(lane, neighbour) pairs whose neighbour lies above the cutoff: the
    pairs that run a clip chain."""
    from fluidsolver_tpu_torch.constants import vf_cutoffs
    from fluidsolver_tpu_torch.vof import cuda_advect

    _, _, vf, rec, iig, jjg, _, _ = args
    lo, _ = vf_cutoffs(vf.dtype)
    return int((cuda_advect.gather_neighbourhood(vf, rec, iig, jjg)[0] > lo).sum())


def check_overlap(errors: Errors, args, main: bool, tag: str) -> None:
    """overlap against its twin on every lane (f64: 1e-13 absolute on the
    overlap, 1e-10 relative and 1e-15 absolute on the start area; f32: the
    relative 1e-5)."""
    from fluidsolver_tpu_torch.vof import cuda_advect

    ok_, ak = cuda_advect.overlap_cuda(*args)
    ot, at = cuda_advect.overlap_twin(*args)
    dtype = args[2].dtype
    errors.compare("overlap", [ok_], [ot], dtype, 0.0, 1e-13, main, tag + " overlap")
    errors.compare("overlap", [ak], [at], dtype, 1e-10, 1e-15, main, tag + " start area")


def overlap_limits_phase(device, errors: Errors, vf_bench: np.ndarray, g_bench) -> None:
    """overlap against its twin on overlap_cases, f64 and f32, with each
    case's lanes and working pairs."""
    for dtype in (torch.float64, torch.float32):
        notes = []
        for name, args, n_active in overlap_cases(device, dtype, vf_bench, g_bench):
            check_overlap(errors, args, False, f"{str(dtype)[6:]} {name}")
            notes.append(f"{name}: {args[0].shape[1]} lanes, {n_active} active cells, "
                         f"{working_pairs(args)} working pairs")
        log(f"  {str(dtype)[6:]} overlap agrees with its twin on every lane; " + "; ".join(notes))


def overlap_with(lib, args) -> list:
    """cuda_advect.overlap_cuda through the library ``lib`` (None: this
    commit's): the overlap and the start area."""
    from fluidsolver_tpu_torch.vof import cuda_advect

    with kernel_library(lib):
        return list(cuda_advect.overlap_cuda(*args))


def one_lane(args, k: int) -> tuple:
    """overlap's arguments cut to lane ``k`` alone."""
    sx, sy, vf, rec, iig, jjg, dx, dy = args
    return (sx[:, k:k + 1].contiguous(), sy[:, k:k + 1].contiguous(), vf, rec, iig[k:k + 1].contiguous(),
            jjg[k:k + 1].contiguous(), dx, dy)


def overlap_floors(lib, args) -> tuple:
    """Device ms of ``lib``'s cut-short overlap on ``args``: an empty launch
    of the same grid, the gathers and the cutoff test without the chains
    (the gather floor), and the whole kernel on the lane with the most
    working pairs alone (one chain's latency: the dependency floor)."""
    from fluidsolver_tpu_torch.constants import vf_cutoffs
    from fluidsolver_tpu_torch.poisson import _kernels
    from fluidsolver_tpu_torch.vof import cuda_advect

    sx, sy, vf, rec, iig, jjg, dx, dy = args
    n, mm = vf.shape
    m = sx.shape[1]
    out = torch.empty((2, m), dtype=vf.dtype, device=vf.device)
    lo, _ = vf_cutoffs(vf.dtype)
    stream = _kernels.stream(vf.device)

    def probe(stage):
        rc = lib.fs_overlap_probe(stage, _kernels.dtype_code(vf.dtype), sx.data_ptr(), sy.data_ptr(), iig.data_ptr(),
                                  jjg.data_ptr(), vf.data_ptr(), rec.valid.data_ptr(), rec.nx.data_ptr(),
                                  rec.ny.data_ptr(), rec.d.data_ptr(), n, mm, m, float(dx), float(dy), lo,
                                  out[0].data_ptr(), out[1].data_ptr(), stream)
        require(rc == 0, f"the overlap probe did not launch: cudaError {rc}")

    pairs = (cuda_advect.gather_neighbourhood(vf, rec, iig, jjg)[0] > lo).sum(0)
    alone = one_lane(args, int(pairs.argmax()))
    with kernel_library(lib):
        t_one = time_ms(lambda: cuda_advect.overlap_cuda(*alone), 50, kernel=True)
    return time_ms(lambda: probe(0), 50, kernel=True), time_ms(lambda: probe(1), 50, kernel=True), t_one


def bench_step_overlap_args(device, g, cfg, vf0, n_steps: int = 2) -> list:
    """The arguments of overlap's call in each of the first ``n_steps``
    steps of the bench configuration (phase 6's state, f32), recorded at
    the wrapper."""
    from fluidsolver_tpu_torch.solvers import twophase
    from fluidsolver_tpu_torch.vof import cuda_advect

    calls = []
    overlap = cuda_advect.overlap

    def recording(*args):
        calls.append(args)
        return overlap(*args)

    cuda_advect.overlap = recording
    try:
        state = twophase.init_two_phase_state(g, cfg, vf0, torch.float32, device)
        step = twophase.make_step(g, cfg, torch.float32, device)
        for _ in range(n_steps):
            state = step(state, 1e9)
    finally:
        cuda_advect.overlap = overlap
    require(len(calls) == n_steps, f"{len(calls)} overlap calls in {n_steps} bench steps")
    return calls


def overlap_turns(device, old, new, vf_bench: np.ndarray, g_bench, step_args: list) -> None:
    """overlap of the kernel library ``old`` against ``new``: both outputs
    bitwise equal on every lane of overlap_cases, f64 and f32; then both
    timed in turns (old, new, new, old) in f32 on the bench drop's swirl
    lanes and on the lanes of the bench step's first advections
    (``step_args``)."""
    for dtype in (torch.float64, torch.float32):
        for name, args, _ in overlap_cases(device, dtype, vf_bench, g_bench):
            want, got = overlap_with(old, args), overlap_with(new, args)
            require(all(torch.equal(a, b) for a, b in zip(want, got)),
                    f"overlap {str(dtype)[6:]} {name}: the two libraries' overlap or start area differ")
        log(f"  {str(dtype)[6:]}: overlap's overlap and start area bitwise equal to the parent's on every lane of "
            "the bench drop, the 25-drop box, its budgets n_active // 2 and n_active, its liquid corner and one lane")
    swirl, _ = swirl_lanes(g_bench, vf_bench, torch.float32, device)
    timed = [("the bench drop's swirl lanes", swirl)] + [
        (f"the lanes of bench step {k + 1}'s advection", args) for k, args in enumerate(step_args)]
    for name, args in timed:
        ms = [time_ms(lambda: overlap_with(lib, args), 50, kernel=True) for lib in (old, new, new, old)]
        log(f"  overlap on {name} (f32, {args[0].shape[1]} lanes, {working_pairs(args)} working pairs), device ms in "
            f"turns: parent {ms[0]:.4f}, this {ms[1]:.4f}, this {ms[2]:.4f}, parent {ms[3]:.4f}; this / parent = "
            f"{(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}")


def overlap_report_phase(device, vf_bench: np.ndarray, g_bench, cfg_bench, parent) -> list:
    """overlap in f32 on the bench drop's swirl lanes and on the lanes of
    the bench step's first two advections: lanes and working pairs, the
    kernel's time beside its floors (overlap_floors); with ``parent``, the
    parent's kernel held bitwise to this one's and timed in turns
    (overlap_turns). Returns the bench steps' overlap arguments."""
    from fluidsolver_tpu_torch.poisson import _kernels
    from fluidsolver_tpu_torch.vof import cuda_advect

    swirl, n_swirl = swirl_lanes(g_bench, vf_bench, torch.float32, device)
    step_args = bench_step_overlap_args(device, g_bench, cfg_bench, vf_bench)
    for name, args in [("the bench drop's swirl lanes", swirl)] + [
            (f"the lanes of bench step {k + 1}'s advection", a) for k, a in enumerate(step_args)]:
        t = time_ms(lambda: cuda_advect.overlap_cuda(*args), 50, kernel=True)
        empty, gather, one = overlap_floors(_kernels.lib(), args)
        log(f"  overlap on {name} (f32): {args[0].shape[1]} lanes, {working_pairs(args)} working pairs of "
            f"{9 * args[0].shape[1]}; kernel {t:.4f} ms; floors: empty launch {empty:.4f}, gathers and cutoff test "
            f"{gather:.4f}, the busiest lane alone {one:.4f}")
    if parent is not None:
        overlap_turns(device, parent_lib(parent), None, vf_bench, g_bench, step_args)
    return step_args


def vof_kernel_phase(device, errors: Errors, vf_bench: np.ndarray, g_bench) -> dict:
    """Returns name -> (kernel ms, twin ms, bound ms, bound by)."""
    from fluidsolver_tpu_torch.vof import advect, cuda_advect, cuda_curvature, cuda_elvira, curvature, plic

    g_odd, vf_odd = drops_vf(1023, 771, 25, seed=5)
    inputs = (("bench drop 1026x1026", g_bench, vf_bench, True),
              ("25 drops 1023x771", g_odd, vf_odd, False))
    times = {}
    for dtype in (torch.float64, torch.float32):
        s = itemsize(dtype)
        for name, g, vf_np, main in inputs:
            tag = f"{str(dtype)[6:]} {name}"
            dx, dy = g.dx, g.dy
            vf = torch.as_tensor(vf_np, dtype=dtype, device=device)

            rt, n_off = check_elvira(errors, vf, dx, dy, main, tag)
            n_mixed = int(rt.valid.sum())

            planes = (rt.nx, rt.ny, rt.d, rt.valid)
            check_curvature(errors, planes, dx, dy, main, tag)

            # overlap on the lanes of one advection through a swirl at CFL 0.5
            U, V, Ui, Vi = swirl_velocity(g, dtype, device)
            dt = torch.tensor(0.5 * dx, dtype=dtype, device=device)
            m = advect.default_max_active(g.nx, g.ny)
            lanes = advect.prepare_lanes(vf, U, V, Ui, Vi, g, dt, m)
            args = (lanes.slots_x, lanes.slots_y, vf, rt, lanes.iig, lanes.jjg, dx, dy)
            check_overlap(errors, args, main, tag)
            # the quads of the no_correction variant from the same backtrace
            quads = advect.prepare_lanes(vf, U, V, Ui, Vi, g, dt, m, no_correction=True)
            qargs = (quads.slots_x, quads.slots_y, vf, rt, quads.iig, quads.jjg, dx, dy)
            check_overlap(errors, qargs, main, tag + " quads")
            n_active = int(lanes.n_active)
            log(f"  {tag}: {n_mixed} mixed cells, {n_active} active of {m} lanes: "
                f"elvira ({n_off} near-tie cells), curvature and overlap (octagons and quads) agree")

            if main and dtype == torch.float32:
                nm = vf.numel()
                times["elvira"] = (time_ms(lambda: cuda_elvira.elvira_cuda(vf, dx, dy), 50, kernel=True),
                                   time_ms(lambda: cuda_elvira.elvira_twin(vf, dx, dy), 3),
                                   # vf in; nx, ny, d and a byte plane out;
                                   # ~4000 flops per mixed cell
                                   *bound((2 * s + 1) * nm + 2 * s * nm, 4000 * n_mixed, dtype))
                times["curvature"] = (
                    time_ms(lambda: cuda_curvature.curvature_vm_cuda(*planes, dx, dy), 50, kernel=True),
                    time_ms(lambda: cuda_curvature.curvature_vm_twin(*planes, dx, dy), 3),
                    # valid bytes in, curvature out, 3 planes over the valid
                    # cells' neighbourhoods; ~1000 flops per valid cell
                    *bound((1 + s) * nm + 3 * s * neighbourhood_cells(rt.valid), 1000 * n_mixed, dtype))
                act = ~lanes.is_fill
                lane_cells = torch.zeros_like(rt.valid)
                lane_cells[1 + lanes.iig[act], 1 + lanes.jjg[act]] = True
                times["overlap"] = (
                    time_ms(lambda: cuda_advect.overlap_cuda(*args), 50, kernel=True),
                    time_ms(lambda: cuda_advect.overlap_twin(*args), 3),
                    # per active lane 16 slot values and 2 indices in, 2
                    # values out; 5 fields over the active lanes'
                    # neighbourhoods in; the clip loop's operations
                    *bound((18 * s + 16) * n_active + (4 * s + 1) * neighbourhood_cells(lane_cells),
                           overlap_flops(args, n_active), dtype))
                # the quads: 8 slot values a lane
                times["overlap_n0_4"] = (
                    time_ms(lambda: cuda_advect.overlap_cuda(*qargs), 50, kernel=True),
                    time_ms(lambda: cuda_advect.overlap_twin(*qargs), 3),
                    *bound((10 * s + 16) * n_active + (4 * s + 1) * neighbourhood_cells(lane_cells),
                           overlap_flops(qargs, n_active), dtype))

    # a lane budget below the active set: the advection reports inf
    vf = torch.as_tensor(vf_odd, dtype=torch.float32, device=device)
    U, V, Ui, Vi = swirl_velocity(g_odd, torch.float32, device)
    dt = torch.tensor(0.5 * g_odd.dx, dtype=torch.float32, device=device)
    rec = cuda_elvira.elvira_cuda(vf, g_odd.dx, g_odd.dy)
    m = advect.default_max_active(g_odd.nx, g_odd.ny)
    n_active = int(advect.prepare_lanes(vf, U, V, Ui, Vi, g_odd, dt, m).n_active)
    _, err = advect.advect(vf, rec, U, V, Ui, Vi, g_odd, dt)
    _, err_over = advect.advect(vf, rec, U, V, Ui, Vi, g_odd, dt, max_active=n_active // 2)
    log(f"  overflow case (f32, 25 drops, {n_active} active cells): budget {m} gives vol_err "
        f"{float(err):.3e}; budget {n_active // 2} gives {float(err_over)}")
    require(math.isfinite(float(err)) and float(err) < 1e-4, "the default budget must hold the active set")
    require(math.isinf(float(err_over)), "a lane budget below the active set must give vol_err = inf")

    # the VOF stage reads nothing back to the host: queued behind ~0.1 s of
    # device sleep, it returns while the stream is still busy
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    rec = plic.elvira(vf, g_odd.dx, g_odd.dy)
    advect.advect(vf, rec, U, V, Ui, Vi, g_odd, dt)
    curvature.curvature_quad_volume_matching(vf, rec, g_odd)
    plic.interface_length(rec, g_odd.dx, g_odd.dy)
    pending = not torch.cuda.current_stream(device).query()
    torch.cuda.synchronize()
    log(f"  VOF stage (elvira, advect, curvature, interface length) queued behind a device sleep: "
        f"stream still busy on return: {pending}")
    require(pending, "the VOF stage drained the stream (a host read)")
    return times


# ---- phase 3c --------------------------------------------------------------
def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def momentum_inputs(shape, seed: int, dtype, device) -> list:
    """The twelve inputs of fused_momentum for a centre shape (n, m): U-
    and V-shaped velocities and pressure jumps from a normal distribution,
    face densities 1 or 1000 at random (both branches of the hybrid
    interpolation), viscosities in [1e-3, 0.1], a normal pressure."""
    n, m = shape
    rng = np.random.default_rng(seed)
    u, v, c = (n + 1, m), (n, m + 1), (n, m)

    def rho(s):
        return np.where(rng.random(s) > 0.5, 1000.0, 1.0)

    arrays = [rng.normal(size=u), rng.normal(size=v), rng.normal(size=u), rng.normal(size=v),
              rho(u), rho(v), rho(u), rho(v), rng.uniform(1e-3, 1e-1, c), rng.normal(size=c),
              rng.normal(size=u), rng.normal(size=v)]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


# f64 tolerances (rtol, atol) per output, those of tests/test_torch_fused.py
TOL_AB = ((1e-12, 1e-12), (1e-10, 1e-9), (1e-12, 0.0), (1e-10, 0.0), (1e-9, 1e-9))
TOL_C = ((1e-12, 1e-13), (1e-9, 1e-10), (1e-10, 1e-12))
TOL_INIT = ((1e-13, 1e-13), (1e-13, 1e-12), (1e-12, 0.0), (1e-11, 1e-13), (1e-10, 1e-11))
TOL_MOM = ((0.0, 1e-11), (0.0, 1e-11), (0.0, 1e-12), (0.0, 1e-12))


def check_outputs(errors: Errors, worst: dict, name, got, want, tols, terms, dtype, main, what) -> None:
    """Output k against the twin's; a scalar's f32 scale is the larger of
    |twin| and the two-norm of the terms it sums (terms[k]). Keeps the
    worst error over that scale in ``worst``, vectors and scalars apart."""
    for k, (g, w, (rtol, atol)) in enumerate(zip(got, want, tols)):
        scale = float(w.abs().max())
        if g.dim() == 0 and terms[k] is not None:
            scale = max(scale, float(terms[k].double().norm()))
        err = errors.compare(name, [g], [w], dtype, rtol, atol, main, f"{what} output {k}", scale=scale)
        slot = worst.setdefault(name, [0.0, 0.0])
        slot[g.dim() == 0] = max(slot[g.dim() == 0], err / max(scale, 1e-300))


def cg_inputs(shape, dtype, device) -> dict:
    """The random-jump operator of ``shape`` and the vectors of phase 3c:
    x, r, p, a noise field, z_raw correlated with r (as a preconditioned
    residual is: <r, z> > 0), Ap, rz_ab = <p, Ap> (alpha = 1), sum(r) and
    b_near = A x + 0.1 noise (a right-hand side for which x is a good
    guess)."""
    from fluidsolver_tpu_torch.poisson.linsys import apply_op

    op = random_operator(*shape, seed=13, dtype=dtype, device=device)
    x, r, p, noise, noise2 = (random_field(shape, 400 + k, dtype, device) for k in range(5))
    Ap = apply_op(op, p)
    return dict(op=op, x=x, r=r, p=p, noise=noise, z_raw=r + 0.5 * noise2, Ap=Ap, rz_ab=torch.sum(p * Ap),
                sum_r=torch.sum(r), b_near=apply_op(op, x) + 0.1 * noise)


def step_c_forms(inp: dict, n: int):
    """step_c's four forms, singular or not, with p (the iteration) and
    without (the init); rz_prev = n keeps beta near 1, so z and beta p both
    show in p'. Yields (what, args); the last is the bench's form."""
    rz_prev = torch.tensor(float(n), dtype=inp["r"].dtype, device=inp["r"].device)
    for singular in (False, True):
        for with_p in (False, True):
            yield (f"singular={singular} p={'given' if with_p else 'None'}",
                   (inp["r"], inp["z_raw"], inp["p"] if with_p else None, rz_prev, singular))


def step_init_forms(inp: dict):
    """step_init's six forms: cold, warm with a guess near A x = b (kept)
    and warm with a random right-hand side (rejected), each singular or
    not. Yields (what, (b, x0, singular)); the last warm kept one is the
    bench's form."""
    for what, b, x0 in (("cold", inp["b_near"], None), ("warm rejected", inp["r"], inp["x"]),
                        ("warm kept", inp["b_near"], inp["x"])):
        for singular in (False, True):
            yield f"{what} singular={singular}", (b, x0, singular)


def check_cg(errors: Errors, worst: dict, inp: dict, dtype, main: bool, tag: str) -> None:
    """step_ab, step_c (four forms) and step_init (six forms) against their
    twins, and each kernel called twice: the two results bitwise equal."""
    from fluidsolver_tpu_torch.poisson import cuda_cg

    op, x, r, p, rz_ab = inp["op"], inp["x"], inp["r"], inp["p"], inp["rz_ab"]
    # step_ab with rz = <p, Ap>, so alpha = 1: x' - x = p and r' - r = -Ap
    # stand far above the f32 bound, and a kernel that skipped an axpy or
    # got alpha wrong would fail
    got = cuda_cg.step_ab_cuda(op, x, r, p, rz_ab)
    want = cuda_cg.step_ab_twin(op, x, r, p, rz_ab)
    again = cuda_cg.step_ab_cuda(op, x, r, p, rz_ab)
    check_outputs(errors, worst, "step_ab", got, want, TOL_AB,
                  (None, None, p * inp["Ap"], want[1] ** 2, want[1]), dtype, main, tag)
    require(all(torch.equal(a, b) for a, b in zip(got, again)), f"step_ab {tag}: two calls differ")
    for what, new, old in (("x", got[0], x), ("r", got[1], r)):
        moved = float((new - old).abs().max())
        require(moved > 1e3 * F32_RTOL * float(new.abs().max()),
                f"step_ab {tag}: the update of {what} ({moved:.3e}) is not above the f32 bound")
    for what, args in step_c_forms(inp, x.numel()):
        got = cuda_cg.step_c_cuda(*args, sum_r=inp["sum_r"])
        want = cuda_cg.step_c_twin(*args, sum_r=inp["sum_r"])
        again = cuda_cg.step_c_cuda(*args, sum_r=inp["sum_r"])
        require((got[1] is got[0]) == (args[2] is None), "step_c: p' must be z without p")
        check_outputs(errors, worst, "step_c", got, want, TOL_C, (None, None, r * inp["z_raw"]), dtype, main,
                      f"{tag} {what}")
        require(all(torch.equal(a, b) for a, b in zip(got, again)), f"step_c {tag} {what}: two calls differ")
    for what, (b, x0, singular) in step_init_forms(inp):
        got = cuda_cg.step_init_cuda(op, b, x0, singular)
        want = cuda_cg.step_init_twin(op, b, x0, singular)
        again = cuda_cg.step_init_cuda(op, b, x0, singular)
        b1 = b - b.mean() if singular else b
        check_outputs(errors, worst, "step_init", got, want, TOL_INIT,
                      (None, None, b1 ** 2, want[1] ** 2, want[1]), dtype, main, f"{tag} {what}")
        require(all(torch.equal(a, c) for a, c in zip(got, again)), f"step_init {tag} {what}: two calls differ")
        kept = bool(got[0].abs().max() > 0)
        require(kept == what.startswith("warm kept"), f"step_init {tag} {what}: guess kept = {kept}")


def fused_kernel_phase(device, errors: Errors) -> dict:
    """Kernels 5-8 against their twins. Returns name -> (kernel ms, twin ms,
    bound ms, bound by)."""
    from fluidsolver_tpu_torch.ops import cuda_momentum
    from fluidsolver_tpu_torch.poisson import cuda_cg

    times = {}
    for dtype, shape, main in ((torch.float64, (1026, 1026), True), (torch.float32, (1026, 1026), True),
                               (torch.float64, (1023, 771), False), (torch.float32, (1023, 771), False)):
        tag = f"{str(dtype)[6:]} {shape[0]}x{shape[1]}"
        s = itemsize(dtype)
        n = shape[0] * shape[1]
        worst = {}
        inp = cg_inputs(shape, dtype, device)
        op, x, r, p, z_raw, sum_r = (inp[k] for k in ("op", "x", "r", "p", "z_raw", "sum_r"))
        planes = [op.aC, op.aL, op.aR, op.aB, op.aT]
        scalar = functools.partial(torch.tensor, dtype=dtype, device=device)
        check_cg(errors, worst, inp, dtype, main, tag)

        # fused_momentum, with and without gravity
        ins = momentum_inputs(shape, 31, dtype, device)
        dt = scalar(1e-4)
        hx, hy = 1.0 / (shape[0] - 2), 1.3 / (shape[1] - 2)
        for gravity in ((0.0, 0.0), (0.3, -9.81)):
            kw = dict(dx=hx, dy=hy, rho_eps=1e-3, gx=gravity[0], gy=gravity[1])
            got = cuda_momentum.fused_momentum_cuda(*ins, dt, **kw)
            want = cuda_momentum.fused_momentum_twin(*ins, dt, **kw)
            check_outputs(errors, worst, "fused_momentum", got, want, TOL_MOM, (None,) * 4, dtype, main,
                          f"{tag} gravity={gravity}")
        log(f"  {tag}: step_ab, step_c (4 forms), step_init (6 forms) and fused_momentum (2 forms) agree, "
            "the CG kernels bitwise from call to call; max|kernel - twin| / "
            "scale, vectors and scalars: " + ", ".join(f"{k} {v:.2e} {sc:.2e}" for k, (v, sc) in worst.items()))

        if main and dtype == torch.float32:
            rz_ab, rz_prev = inp["rz_ab"], scalar(float(n))
            times["step_ab"] = (time_ms(lambda: cuda_cg.step_ab_cuda(op, x, r, p, rz_ab), 50, kernel=True),
                                time_ms(lambda: cuda_cg.step_ab_twin(op, x, r, p, rz_ab), 20), *step_ab_bound(inp))
            times["step_c"] = (
                time_ms(lambda: cuda_cg.step_c_cuda(r, z_raw, p, rz_prev, True, sum_r=sum_r), 50, kernel=True),
                time_ms(lambda: cuda_cg.step_c_twin(r, z_raw, p, rz_prev, True, sum_r=sum_r), 20),
                *step_c_bound(inp))
            # the bench's form (warm, singular): 5 planes, b and x0 in, x0' and
            # r0' out; 20 flops per point (2 means, projections, matvec, 4 sums)
            b_near = inp["b_near"]
            bnd = bound(nbytes(*planes, b_near, x) + nbytes(b_near, x) + 3 * s, 20 * n, dtype)
            times["step_init"] = (
                time_ms(lambda: cuda_cg.step_init_cuda(op, b_near, x, True), 50, kernel=True),
                time_ms(lambda: cuda_cg.step_init_twin(op, b_near, x, True), 20), *bnd)
            # the bench's form (no gravity): 12 planes in, 4 out; ~120 flops
            # per cell with each flux formed once
            kw = dict(dx=hx, dy=hy, rho_eps=1e-3, gx=0.0, gy=0.0)
            outs = cuda_momentum.fused_momentum_twin(*ins, dt, **kw)
            bnd = bound(nbytes(*ins, dt) + nbytes(*outs), 120 * n, dtype)
            times["fused_momentum"] = (
                time_ms(lambda: cuda_momentum.fused_momentum_cuda(*ins, dt, **kw), 50, kernel=True),
                time_ms(lambda: cuda_momentum.fused_momentum_twin(*ins, dt, **kw), 20), *bnd)
    return times


def rhs_inputs(shape, seed: int, dtype, device) -> list:
    """The nine field inputs of fused_rhs for a centre shape (n, m): a drop
    of radius 0.3 (in units of the box) whose fraction ramps over three
    cells, curvatures from a normal distribution and interface lengths in
    [0, 1.5] on its mixed cells (0 elsewhere, so both sides of the face
    curvature's test occur), normal velocities and old jumps, face
    densities 1 or 1000 at random."""
    n, m = shape
    rng = np.random.default_rng(seed)
    u, v = (n + 1, m), (n, m + 1)
    x = (np.arange(n) + 0.5)[:, None] / n
    y = (np.arange(m) + 0.5)[None, :] / m
    r = np.sqrt((x - 0.45) ** 2 + ((y - 0.55) * m / n) ** 2)
    vf = np.clip((0.3 - r) * n / 3.0 + 0.5, 0.0, 1.0)
    mixed = (vf > 0.0) & (vf < 1.0)
    curv = np.where(mixed, rng.normal(size=(n, m)), 0.0)
    length = np.where(mixed, rng.uniform(0.0, 1.5, (n, m)), 0.0)

    def rho(s):
        return np.where(rng.random(s) > 0.5, 1000.0, 1.0)

    arrays = [rng.normal(size=u), rng.normal(size=v), vf, curv, length, rho(u), rho(v), rng.normal(size=u),
              rng.normal(size=v)]
    return [torch.as_tensor(a, dtype=dtype, device=device) for a in arrays]


def rhs_kernel_phase(device, errors: Errors) -> dict:
    """Kernel 13, fused_rhs, against its twin: torch.equal on every output
    at the channel's 10242 x 2050 in f64 and at 1026^2 and 1023 x 771 in
    f32 and f64, each called twice; bf16 refused. Times the kernel, the
    twin and the bound (12 planes once; about 60 flops a cell) at the
    channel's shape and at 1026^2 f32. Returns name -> (kernel ms, twin ms,
    bound ms, bound by) at 1026^2 f32, the kernel table's shape."""
    from fluidsolver_tpu_torch.ops import cuda_rhs

    times = {}
    for dtype, shape, main in ((torch.float64, (10242, 2050), True), (torch.float32, (1026, 1026), True),
                               (torch.float64, (1026, 1026), False), (torch.float32, (1023, 771), False),
                               (torch.float64, (1023, 771), False)):
        tag = f"{str(dtype)[6:]} {shape[0]}x{shape[1]}"
        ins = rhs_inputs(shape, 17, dtype, device)
        dt = torch.tensor(1.3e-4, dtype=dtype, device=device)
        kw = dict(sigma=1.0 / 200, dx=2.2 / (shape[0] - 2), dy=0.41 / (shape[1] - 2))
        got = cuda_rhs.fused_rhs_cuda(*ins, dt, **kw)
        want = cuda_rhs.fused_rhs_twin(*ins, dt, **kw)
        again = cuda_rhs.fused_rhs_cuda(*ins, dt, **kw)
        torch.cuda.synchronize()
        errors.compare("fused_rhs", got, want, dtype, 0.0, 0.0, main, tag)
        require(all(torch.equal(a, b) for a, b in zip(got, want)), f"fused_rhs {tag}: not bitwise its twin")
        require(all(torch.equal(a, b) for a, b in zip(got, again)), f"fused_rhs {tag}: two calls differ")
        has = [int((w != 0).sum()) for w in want]
        require(min(has) > 0, f"fused_rhs {tag}: an output is all zero")
        log(f"  {tag}: fused_rhs bitwise its twin (div, p_jump_u, p_jump_v), non-zero {has}")
        if main:
            n = shape[0] * shape[1]
            bnd = bound(12 * n * itemsize(dtype), 60 * n, dtype)
            t = (time_ms(lambda: cuda_rhs.fused_rhs_cuda(*ins, dt, **kw), 50, kernel=True),
                 time_ms(lambda: cuda_rhs.fused_rhs_twin(*ins, dt, **kw), 20), *bnd)
            log(f"  {tag}: fused_rhs {t[0]:.4f} ms, twin {t[1]:.4f} ms, bound {t[2]:.4f} ms ({t[3]}): "
                f"{100 * t[2] / t[0]:.1f}% of the bound")
            if dtype == torch.float32:
                times["fused_rhs"] = t
        del got, want, again, ins
    bf16 = [t.to(torch.bfloat16) for t in rhs_inputs((66, 34), 17, torch.float32, device)]
    try:
        cuda_rhs.fused_rhs_cuda(*bf16, torch.tensor(1e-4, dtype=torch.bfloat16, device=device), sigma=0.005,
                                dx=0.01, dy=0.01)
    except RuntimeError as exc:
        log(f"  bf16 refused: {exc}")
    else:
        require(False, "fused_rhs took bf16 operands")
    return times


def step_ab_bound(inp: dict) -> tuple:
    """step_ab's bound: 5 planes and x, r, p in, x' and r' out; 18 flops per
    point (matvec 9, 3 dots 5, 2 axpys 4)."""
    op, x = inp["op"], inp["x"]
    s = x.element_size()
    return bound(nbytes(op.aC, op.aL, op.aR, op.aB, op.aT, x, inp["r"], inp["p"], inp["rz_ab"]) + 2 * nbytes(x)
                 + 3 * s, 18 * x.numel(), x.dtype)


def step_c_bound(inp: dict) -> tuple:
    """step_c's bound in the bench's form (singular, p given): r, z_raw, p
    in, z and p' out; 6 flops per point."""
    r = inp["r"]
    s = r.element_size()
    return bound(3 * nbytes(r) + 2 * s + 2 * nbytes(r) + s, 6 * r.numel(), r.dtype)


# the CG kernels at the limits of their virtual grid: 16 virtual blocks
# (64^2), n not a multiple of 256 (37 x 29), points past the ones a thread
# holds in registers (2050 x 1026)
CG_LIMIT_SHAPES = ((64, 64), (37, 29), (2050, 1026))


def cg_limits_phase(device, errors: Errors) -> None:
    """step_ab, step_c and step_init against their twins, and bitwise from
    call to call, at CG_LIMIT_SHAPES in f64 and f32."""
    for dtype in (torch.float64, torch.float32):
        for shape in CG_LIMIT_SHAPES:
            tag = f"{str(dtype)[6:]} {shape[0]}x{shape[1]}"
            worst = {}
            check_cg(errors, worst, cg_inputs(shape, dtype, device), dtype, False, tag)
            log(f"  {tag}: step_ab, step_c (4 forms) and step_init (6 forms) agree, bitwise from call to call; "
                "max|kernel - twin| / "
                "scale, vectors and scalars: " + ", ".join(f"{k} {v:.2e} {sc:.2e}" for k, (v, sc) in worst.items()))


def step_ab_raw(lib, inp: dict):
    """fs_step_ab of ``lib`` on ``inp`` (rz = rz_ab): (x', r', scal[:4])."""
    from fluidsolver_tpu_torch.poisson import _kernels, cuda_cg

    op, x = inp["op"], inp["x"]
    x_out, r_out = torch.empty_like(x), torch.empty_like(x)
    part, scal = cuda_cg._scratch(x)
    rc = lib.fs_step_ab(_kernels.dtype_code(x.dtype), _kernels.ptrs(cuda_cg._planes(op)), x.data_ptr(),
                        inp["r"].data_ptr(), inp["p"].data_ptr(), inp["rz_ab"].data_ptr(), *x.shape,
                        x_out.data_ptr(), r_out.data_ptr(), None, part.data_ptr(), scal.data_ptr(),
                        _kernels.stream(x.device))
    require(rc == 0, f"fs_step_ab did not launch: cudaError {rc}")
    return x_out, r_out, scal[:4]


def step_c_raw(lib, args, sum_r):
    """fs_step_c of ``lib`` on step_c's ``args``: (z, p' or None, scal[:3])."""
    from fluidsolver_tpu_torch.poisson import _kernels, cuda_cg

    r, z_raw, p, rz_prev, singular = args
    z_out = torch.empty_like(r)
    p_out = None if p is None else torch.empty_like(r)
    part, scal = cuda_cg._scratch(r)
    rc = lib.fs_step_c(_kernels.dtype_code(r.dtype), r.data_ptr(), z_raw.data_ptr(),
                       None if p is None else p.data_ptr(), rz_prev.data_ptr(),
                       sum_r.data_ptr() if singular else None, int(singular), r.numel(), z_out.data_ptr(),
                       None if p_out is None else p_out.data_ptr(), part.data_ptr(), scal.data_ptr(),
                       _kernels.stream(r.device))
    require(rc == 0, f"fs_step_c did not launch: cudaError {rc}")
    return z_out, p_out, scal[:3]


def step_init_raw(lib, op, args):
    """fs_step_init of ``lib`` on step_init's ``args`` (b, x0 or None,
    singular): (x0', r0', then views of the scalars it defines: bb, rr0 and
    sum_r0, good, and, singular, the means of b and x0)."""
    from fluidsolver_tpu_torch.poisson import _kernels, cuda_cg

    b, x0, singular = args
    x_out, r_out = torch.empty_like(b), torch.empty_like(b)
    part, scal = cuda_cg._scratch(b)
    rc = lib.fs_step_init(_kernels.dtype_code(b.dtype), _kernels.ptrs(cuda_cg._planes(op)), b.data_ptr(),
                          None if x0 is None else x0.data_ptr(), int(singular), *b.shape, x_out.data_ptr(),
                          r_out.data_ptr(), part.data_ptr(), scal.data_ptr(), _kernels.stream(b.device))
    require(rc == 0, f"fs_step_init did not launch: cudaError {rc}")
    return (x_out, r_out, scal[:3], scal[5:6]) + ((scal[3:5],) if singular else ())


def cg_turns(device, old, new) -> None:
    """step_ab, step_c and step_init of the kernel library ``old`` against
    ``new`` on the same inputs: every vector output and every scalar they
    define bitwise equal, in f64 and f32 at 1026^2, 1023 x 771 and
    CG_LIMIT_SHAPES, all four forms of step_c and all six of step_init;
    then each timed in turns (old, new, new, old) in the bench forms at
    1026^2 f32, on one set of inputs (which the 50 MB L2 holds) and
    rotating over three (which it does not)."""
    for dtype in (torch.float64, torch.float32):
        for shape in ((1026, 1026), (1023, 771)) + CG_LIMIT_SHAPES:
            tag = f"{str(dtype)[6:]} {shape[0]}x{shape[1]}"
            inp = cg_inputs(shape, dtype, device)
            want, got = step_ab_raw(old, inp), step_ab_raw(new, inp)
            require(all(torch.equal(a, b) for a, b in zip(want, got)),
                    f"step_ab {tag}: the two libraries' outputs differ")
            for what, args in step_c_forms(inp, inp["x"].numel()):
                want, got = step_c_raw(old, args, inp["sum_r"]), step_c_raw(new, args, inp["sum_r"])
                require(all((a is None and b is None) or torch.equal(a, b) for a, b in zip(want, got)),
                        f"step_c {tag} {what}: the two libraries' outputs differ")
            for what, args in step_init_forms(inp):
                want, got = step_init_raw(old, inp["op"], args), step_init_raw(new, inp["op"], args)
                require(all(torch.equal(a, b) for a, b in zip(want, got)),
                        f"step_init {tag} {what}: the two libraries' outputs differ")
            log(f"  {tag}: step_ab, step_c (4 forms) and step_init (6 forms) bitwise equal to the parent's "
                "(every output and scalar)")
    sets = [cg_inputs((1026, 1026), torch.float32, device) for _ in range(3)]
    forms = [list(step_c_forms(inp, inp["x"].numel()))[-1][1] for inp in sets]
    inits = [list(step_init_forms(inp))[-1][1] for inp in sets]
    runs = {"step_ab": lambda lib, k: step_ab_raw(lib, sets[k]),
            "step_c": lambda lib, k: step_c_raw(lib, forms[k], sets[k]["sum_r"]),
            "step_init": lambda lib, k: step_init_raw(lib, sets[k]["op"], inits[k])}
    for name, run in runs.items():
        for n_sets, how in ((1, "one input set"), (3, "three input sets in rotation")):
            ms = []
            for lib in (old, new, new, old):
                turn = itertools.count()
                ms.append(time_ms(lambda: run(lib, next(turn) % n_sets), 48, kernel=True))
            log(f"  {name} (f32 1026^2, bench form, {how}), device ms in turns: parent {ms[0]:.4f}, "
                f"this {ms[1]:.4f}, this {ms[2]:.4f}, parent {ms[3]:.4f}; this / parent = "
                f"{(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}")


# ---- phase 3d --------------------------------------------------------------
def sweep_phase(device, errors: Errors) -> dict:
    """rb_sweep against its twin at every level shape of the "mg" hierarchy
    of a 1026^2 and a 1023 x 771 box, both orders, from a zero and a random
    x. Returns name -> (kernel ms, twin ms, bound ms, bound by)."""
    from fluidsolver_tpu_torch.poisson import cuda_smoother, mg

    times = {}
    for dtype, shape, main in ((torch.float64, (1026, 1026), True), (torch.float32, (1026, 1026), True),
                               (torch.float64, (1023, 771), False), (torch.float32, (1023, 771), False)):
        tag = f"{str(dtype)[6:]} {shape[0]}x{shape[1]}"
        levels = mg.build_hierarchy(random_operator(*shape, seed=13, dtype=dtype, device=device))
        bitwise, worst = True, 0.0
        for lvl, op in enumerate(levels):
            lshape = tuple(op.aC.shape)
            b = random_field(lshape, 500 + lvl, dtype, device)
            for x0 in (torch.zeros_like(b), random_field(lshape, 600 + lvl, dtype, device)):
                for reverse in (False, True):
                    got = cuda_smoother.rb_sweep_cuda(op, x0, b, reverse)
                    want = cuda_smoother.rb_sweep_twin(op, x0, b, reverse)
                    err = errors.compare("rb_sweep", [got], [want], dtype, 1e-12, 1e-12, main,
                                         f"{tag} level {lshape} reverse={reverse}")
                    worst = max(worst, err)
                    bitwise = bitwise and torch.equal(got, want)
        log(f"  {tag}: {len(levels)} levels, sides {[tuple(lv.aC.shape) for lv in levels]}: rb_sweep "
            f"agrees (both orders, zero and random x); max|kernel - twin| {worst:.3e}, bitwise {bitwise}")
        if main and dtype == torch.float32:
            op = levels[0]
            b, x0 = (random_field(shape, 700 + k, dtype, device) for k in range(2))
            n = b.numel()
            # 5 planes, b and x in, x out; 13 flops per point (A x - aC x:
            # 6 products and 5 sums; b minus it; one division)
            bnd = bound(8 * itemsize(dtype) * n, 13 * n, dtype)
            times["rb_sweep"] = (
                time_ms(lambda: cuda_smoother.rb_sweep_cuda(op, x0, b), 50, kernel=True),
                time_ms(lambda: cuda_smoother.rb_sweep_twin(op, x0, b), 20), *bnd)
    return times


# ---- phase 4 ---------------------------------------------------------------
def cross_check_phase(device) -> None:
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.solvers.state import state_to_numpy

    case = get_case("lid_driven", n=256)
    case.cfg = dataclasses.replace(case.cfg, pressure_tol=1e-11)
    runs = {}
    for dev in (device, torch.device("cpu")):
        state = case.make_state(torch.float64, dev)
        step = case.make_step(torch.float64, dev)
        iters = []
        for _ in range(3):
            state = step(state, case.t_end)
            iters.append(int(state.p_iter))
        runs[dev.type] = (state_to_numpy(state), iters)
    (g, ig), (c, ic) = runs["cuda"], runs["cpu"]
    for k in ("U", "V", "p"):
        rel = float(np.abs(g[k] - c[k]).max() / np.abs(c[k]).max())
        log(f"  {k}: max|gpu - cpu| / max|cpu| = {rel:.3e}")
        require(rel <= 1e-9, f"lid_driven(256) f64 {k} differs by {rel:.3e} > 1e-9")
    log(f"  p_iter per step: gpu {ig}, cpu {ic}")
    require(all(abs(a - b) <= 1 for a, b in zip(ig, ic)), "p_iter differs by more than 1")


# ---- phase 4b --------------------------------------------------------------
def golden_drop():
    """The golden two-phase drop of tests/golden_cases.py: 64^2, 1000:1,
    sigma 0.02, gravity, all-Neumann walls, pressure pinned right, tol 1e-10,
    15 steps of dt_max = 2.5e-3."""
    from fluidsolver_tpu_torch.core import bc
    from fluidsolver_tpu_torch.core.grid import make_grid
    from fluidsolver_tpu_torch.solvers.config import SolverConfig
    from fluidsolver_tpu_torch.vof.init import liquid_fraction_from_indicator

    g = make_grid(0.0, 1.0, 64, 0.0, 1.0, 64)
    cfg = SolverConfig(
        rho_gas=1.0, rho_liquid=1e3, visc_gas=1e-3, visc_liquid=1e-2,
        sigma=0.02, cfl_max=0.5, dt_max=2.5e-3, num_subiter=2,
        pressure_tol=1e-10, pressure_max_iter=200, pressure_pin="right",
        bcs=bc.FlowBCs(bc.Neumann(), bc.Neumann(), bc.Neumann(), bc.Neumann()),
        gravity=(0.0, -1.0),
    )
    vf0 = liquid_fraction_from_indicator(lambda x, y: (x - 0.5) ** 2 + (y - 0.65) ** 2 <= 0.2**2, g)
    return g, cfg, vf0, 15 * 2.5e-3


def two_phase_cross_check_phase(device) -> None:
    """The golden drop on the card and on the CPU; the GPU run must launch
    kernels 5-8."""
    from fluidsolver_tpu_torch.poisson import _kernels
    from fluidsolver_tpu_torch.solvers import twophase

    g, cfg, vf0, t_end = golden_drop()
    gold = dict(np.load(Path(__file__).resolve().parent / "tests" / "goldens" / "two_phase_drop.npz"))
    runs = {}
    for dev in (device, torch.device("cpu")):
        iters = []
        _kernels.launches.clear()
        state = twophase.init_two_phase_state(g, cfg, vf0, torch.float64, dev)
        state = twophase.run(state, t_end, g, cfg, callback=lambda s: iters.append(int(s.flow.p_iter)))
        out = {"U": state.flow.U, "V": state.flow.V, "p": state.flow.p, "vf": state.vf, "curv": state.curv}
        runs[dev.type] = ({k: v.cpu().numpy() for k, v in out.items()}, iters, float(state.flow.t))
        if dev.type == "cuda":
            seen = {k: _kernels.launches.get(k, 0) for k in FUSED}
            log(f"  launches of kernels 5-8 on the card: {seen}")
            require(all(seen.values()), "the golden drop on the card must launch kernels 5-8")
    (gpu, ig, tg), (cpu, ic, tc) = runs["cuda"], runs["cpu"]
    require(abs(tg - float(gold["t"])) <= 1e-14 and abs(tc - float(gold["t"])) <= 1e-14,
            f"end times {tg}, {tc} differ from the golden {float(gold['t'])}")
    for k in gpu:
        rel = float(np.abs(gpu[k] - cpu[k]).max() / np.abs(cpu[k]).max())
        rel_g = float(np.abs(gpu[k] - gold[k]).max() / np.abs(gold[k]).max())
        rel_c = float(np.abs(cpu[k] - gold[k]).max() / np.abs(gold[k]).max())
        log(f"  {k}: |gpu - cpu| {rel:.3e}, |gpu - golden| {rel_g:.3e}, |cpu - golden| {rel_c:.3e} "
            "(max abs over max|ref|)")
        require(rel <= 1e-9, f"two-phase drop f64 {k}: gpu vs cpu {rel:.3e} > 1e-9")
        require(rel_g <= 1e-8 and rel_c <= 1e-8, f"two-phase drop f64 {k}: off the golden by > 1e-8")
    log(f"  p_iter per step: gpu {ig}, cpu {ic}")
    require(len(ig) == len(ic) == 15 and all(abs(a - b) <= 1 for a, b in zip(ig, ic)),
            "p_iter differs by more than 1")


# ---- phase 4c --------------------------------------------------------------
def solver_cross_check_phase(device) -> None:
    """lid_driven(64), f64, 2 steps, GPU against CPU for every pressure
    method and preconditioner and for the direct solve. Tol 1e-11 with a
    cap of 2000 iterations, so that BiCGSTAB with a weak preconditioner
    converges: stopped early, its iterates move with the order of the
    sums. Its residual is not monotone, so there its count may move by 10%
    (the step at which it first falls below tol); elsewhere by 1. The "mg"
    runs on the card must launch rb_sweep."""
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.poisson import _kernels
    from fluidsolver_tpu_torch.solvers.state import state_to_numpy

    combos = [(m, p) for m in ("pcg", "bicgstab", "gmres") for p in ("mg", "boxmg", "jacobi", "none")]
    combos += [("mgsolve", "mg"), ("mgsolve", "boxmg"), ("pcg", "direct")]
    for method, solver in combos:
        case = get_case("lid_driven", n=64)
        case.cfg = dataclasses.replace(case.cfg, pressure_tol=1e-11, pressure_max_iter=2000,
                                       pressure_method=method, pressure_solver=solver)
        runs = {}
        for dev in (device, torch.device("cpu")):
            _kernels.launches.clear()
            state = case.make_state(torch.float64, dev)
            step = case.make_step(torch.float64, dev)
            iters = []
            for _ in range(2):
                state = step(state, case.t_end)
                iters.append(int(state.p_iter))
            runs[dev.type] = (state_to_numpy(state), iters, _kernels.launches.get("rb_sweep", 0))
        (g, ig, sweeps), (c, ic, _) = runs["cuda"], runs["cpu"]
        rel = max(float(np.abs(g[k] - c[k]).max() / np.abs(c[k]).max()) for k in ("U", "V", "p"))
        slack = [max(1, i // 10) if (method == "bicgstab" and solver in ("jacobi", "none")) else 1
                 for i in ic]
        log(f"  {method} + {solver}: max over U, V, p of max|gpu - cpu| / max|cpu| = {rel:.3e}; "
            f"p_iter gpu {ig}, cpu {ic}; rb_sweep launches on the card {sweeps}")
        require(rel <= 1e-9, f"{method} + {solver}: gpu vs cpu {rel:.3e} > 1e-9")
        require(all(abs(a - b) <= d for a, b, d in zip(ig, ic, slack)),
                f"{method} + {solver}: p_iter differs by more than {slack}")
        require((sweeps > 0) == (solver == "mg"), f"{method} + {solver}: {sweeps} rb_sweep launches")


# ---- phase 4d --------------------------------------------------------------
def driver_rows(sim, stash=None, **run) -> list:
    """Run ``sim`` (a ``driver.Simulation``): the observed values of its
    initial state and of each step; ``stash(state)``, if given, is called
    after each step."""
    rows = [dict(sim.observe())]

    def record(state):
        rows.append(dict(sim.observe()))
        if stash is not None:
            stash(state)

    sim.run(callback=record, **run)
    return rows


def check_rows(gpu: list, cpu: list, tol: float, dx: float, pressure_tol: float) -> None:
    """The observed columns of a GPU run against a CPU run: each to ``tol``
    relative to its column's scale, except the solver's exit values (the
    residual below the tolerance in both, the iteration count within 1 a
    step, max|div| within ``tol`` of max|U|/dx)."""
    require(len(gpu) == len(cpu), f"{len(gpu)} against {len(cpu)} observed rows")
    worst = {}
    for name in cpu[0]:
        a = np.array([row[name] for row in gpu])
        b = np.array([row[name] for row in cpu])
        diff = float(np.abs(a - b).max())
        if name == "iter(p)":
            require(diff <= 1, f"iter(p) differs by {diff}: gpu {a.tolist()}, cpu {b.tolist()}")
        elif name == "res(p)":
            require(max(a.max(), b.max()) <= pressure_tol, f"res(p) above the tolerance: {a}, {b}")
        else:
            scale = 1.0 if name in ("min(vof)", "max(vof)") else (np.abs(b).max() or 1.0)
            if name == "max(div)":
                scale = max(np.abs([row["max(U)"] for row in cpu]).max(), 1.0) / dx
            worst[name] = diff / scale
            require(diff <= tol * scale, f"column {name}: gpu {a.tolist()}, cpu {b.tolist()}")
    log("  observed columns, max |gpu - cpu| over the column's scale: "
        + ", ".join(f"{k} {v:.2e}" for k, v in worst.items()))


def driver_cross_check_phase(device) -> None:
    """The driver (``Simulation``) on the card against the CPU, f64:
    two_phase_channel(ny=16), tol 1e-11 (1e-9 on subiterations 0-3), 3
    steps; vof_tgv(n=64), 10 kinematic steps."""
    from fluidsolver_tpu_torch import driver
    from fluidsolver_tpu_torch.cases import get_case

    case = get_case("two_phase_channel", ny=16)
    case.cfg = dataclasses.replace(case.cfg, pressure_tol=1e-11, pressure_tol_intermediate=1e-9)
    runs = []
    for dev in (device, torch.device("cpu")):
        sim = driver.Simulation(case, dtype=torch.float64, device=dev, save_output=False)
        rows = driver_rows(sim, max_steps=3)
        fl = sim.state.flow
        runs.append((rows, {k: t.cpu().numpy() for k, t in
                            (("U", fl.U), ("V", fl.V), ("p", fl.p), ("vf", sim.state.vf))}))
    (g_rows, g), (c_rows, c) = runs
    log(f"  two_phase_channel(16): iter(p) per step gpu {[int(r['iter(p)']) for r in g_rows[1:]]}, "
        f"cpu {[int(r['iter(p)']) for r in c_rows[1:]]}")
    check_rows(g_rows, c_rows, 1e-9, case.grid.dx, case.cfg.pressure_tol)
    for k in g:
        rel = float(np.abs(g[k] - c[k]).max() / np.abs(c[k]).max())
        log(f"  two_phase_channel(16) {k}: max|gpu - cpu| / max|cpu| = {rel:.3e}")
        require(rel <= 1e-9, f"driver two_phase_channel(16) f64 {k} differs by {rel:.3e} > 1e-9")

    case = get_case("vof_tgv", n=64)
    runs = []
    for dev in (device, torch.device("cpu")):
        errs = []
        sim = driver.Simulation(case, dtype=torch.float64, device=dev, save_output=False)
        driver_rows(sim, stash=lambda s: errs.append(s.vof_vol_error), max_steps=10)
        runs.append((sim.state.vf.cpu().numpy(), [float(e) for e in errs], sim.n_steps))
    (g_vf, g_err, g_n), (c_vf, c_err, c_n) = runs
    rel = float(np.abs(g_vf - c_vf).max() / np.abs(c_vf).max())
    log(f"  vof_tgv(64), {g_n} steps: vf max|gpu - cpu| / max|cpu| = {rel:.3e}; "
        f"vof_vol_error per step gpu max {max(g_err):.3e}, cpu max {max(c_err):.3e}")
    require(g_n == c_n == 10, f"{g_n}, {c_n} kinematic steps")
    require(rel <= 1e-9, f"vof_tgv(64) f64 vf differs by {rel:.3e} > 1e-9")
    require(max(g_err + c_err) < 1e-12, "vof_tgv(64): a step's volume error is not below 1e-12")


# ---- phase 5 ---------------------------------------------------------------
def full_size_phase(device) -> None:
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.core import sync
    from fluidsolver_tpu_torch.ops import stencil
    from fluidsolver_tpu_torch.poisson import _kernels

    case = get_case("lid_driven", n=1024)
    dtype = torch.float32
    state = case.make_state(dtype, device)
    torch.cuda.synchronize()

    _kernels.launches.clear()
    step = case.make_step(dtype, device)
    ms, iters, res, syncs = [], [], [], []
    for _ in range(20):
        s0 = sync.count
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state = step(state, case.t_end)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        syncs.append(sync.count - s0)
        iters.append(int(state.p_iter))
        res.append(float(state.p_res))
    launches = dict(_kernels.launches)
    log(f"  launches in make_step + 20 steps: {launches}")
    for name in ("fused_rap", "fused_smooth", "tail_setup", "tail_cycle"):
        require(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    # one V-cycle per PCG iteration plus one per solve; each runs one tail
    # cycle and two smoothing phases per level above the tail
    n_above = len(step.levels) - 1
    cycles = sum(iters) + 20 * case.cfg.num_subiter
    require(launches["tail_cycle"] == cycles and launches["fused_smooth"] == 2 * n_above * cycles,
            f"expected {cycles} tail cycles and {2 * n_above * cycles} smoothing phases")
    # one step_init and one init-form step_c per solve, one step_ab and one
    # step_c per PCG iteration
    solves = 20 * case.cfg.num_subiter
    pcg = {"step_init": solves, "step_ab": sum(iters), "step_c": sum(iters) + solves}
    require(all(launches.get(k, 0) == v for k, v in pcg.items()), f"expected PCG kernel launches {pcg}")

    g = case.grid
    div = stencil.divergence(state.U, state.V, g.dx, g.dy)[1:-1, 1:-1]
    max_div = float(div.abs().max())
    finite = all(bool(torch.isfinite(t).all()) for t in (state.U, state.V, state.p))
    warm = ms[3:]
    log(f"  ms/step (CUDA events; median of steps 4-20): {statistics.median(warm):.4f}; "
        f"all steps: {[round(v, 3) for v in ms]}")
    log(f"  p_iter per step: {iters}")
    log(f"  p_res per step: {['%.3e' % r for r in res]}")
    log(f"  host syncs per step: {syncs}")
    log(f"  max|div| after projection: {max_div:.3e}; t = {float(state.t):.6f}")
    require(finite, "non-finite U, V or p")

    # kernels seen by the profiler over make_step + one step
    with device_trace() as prof:
        step = case.make_step(dtype, device)
        state = step(state, case.t_end)
        torch.cuda.synchronize()
    names = [e.name for e in device_events(prof)]
    pressure_kernels = ("fused_rap", "fused_smooth", "tail_setup", "tail_cycle")
    counts = {k: sum(any(t in n for t in TRACE_NAMES[k]) for n in names) for k in pressure_kernels}
    log(f"  profiler: {len(names)} device events; our kernels: {counts}; "
        f"PCG iterations in the profiled step: {int(state.p_iter)}")
    require(len(names) > 0, "the profiler recorded no device events")
    require(counts["fused_rap"] == 3 and counts["tail_setup"] == 1,
            "make_step should launch fused_rap 3 times and tail_setup once")
    cycles = int(state.p_iter) + case.cfg.num_subiter
    require(counts["tail_cycle"] == cycles and counts["fused_smooth"] == 2 * n_above * cycles,
            f"the profiled step should run {cycles} tail cycles and {2 * n_above * cycles} "
            "smoothing phases (every PCG iteration)")

    # where the device time of 3 steps goes, and the device's idle share
    by_name, busy, wall_us, _ = profile_steps(lambda: step(state, case.t_end), 3)
    log(f"  3 profiled steps: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
        f"idle share {1 - busy / wall_us:.3f}; device time by kernel (ms, launches):")
    for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {t / 1e3:9.4f}  {c:5d}  {n}")


@contextlib.contextmanager
def device_trace():
    """torch.profiler (CPU and CUDA) over the block, after one warm-up cycle
    (a device sleep, its events discarded) that brings the device trace up:
    without it a trace has missed a kernel at the start of its window."""
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        prof.step()
        yield prof
        torch.cuda.synchronize()
        prof.step()


def device_events(prof) -> list:
    """The device-side events of a ``device_trace``, without the span its
    schedule annotates over the window (``ProfilerStep#n``)."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and not e.name.startswith("ProfilerStep")]


def profile_steps(run_step, n: int):
    """Profile ``n`` calls of ``run_step``. Returns (device time by kernel
    name -> (us, launches), busy us, wall us, range name -> device us). A
    kernel counts toward each of the program's profiler ranges
    (``twophase.*``, ``pcg.*``) whose span on the device timeline it starts
    inside; the ranges' own device-side spans are no work."""

    def is_range(name):
        return name.startswith(("twophase.", "pcg."))

    with device_trace() as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    device = device_events(prof)
    spans = [(e.name, e.time_range.start, e.time_range.end) for e in device if is_range(e.name)]
    by_name, ranges = {}, {}
    for e in device:
        if is_range(e.name):
            continue
        us = e.time_range.elapsed_us()
        name = next((k for k, v in TRACE_NAMES.items() if any(n in e.name for n in v)), e.name[:70])
        t, c = by_name.get(name, (0.0, 0))
        by_name[name] = (t + us, c + 1)
        for r in {r for r, start, end in spans if start <= e.time_range.start < end}:
            ranges[r] = ranges.get(r, 0.0) + us
    busy = sum(t for t, _ in by_name.values())
    return by_name, busy, wall_us, ranges


# ---- phase 6 ---------------------------------------------------------------
def above_tail_levels(shape) -> int:
    """Levels built by fused_rap (above the coarse tail) for a finest box of
    ``shape``: the structure of boxmg.build_hierarchy, decided by shape."""
    from fluidsolver_tpu_torch.poisson import boxmg

    built = 0
    while True:
        n_rem = boxmg._remaining_depth(shape, built)
        if boxmg.tail_fits(shape, n_rem) or n_rem == 1:
            return built
        built += 1
        shape = ((shape[0] + 1) // 2, (shape[1] + 1) // 2)


def drive_bench(device, g, cfg, vf0, n_steps: int, syncs_out=None, mesh=None):
    """``n_steps`` steps of the two-phase configuration ``cfg`` in f32 from
    the drop ``vf0``, each timed by CUDA events, with the launch counts set
    to 0 just before the first step and read just after the last. Returns
    (step, state, launches, p_iter per step); the host syncs of each step
    are appended to ``syncs_out`` if given; ``mesh``: the mesh step's
    slabs."""
    from fluidsolver_tpu_torch.core import sync
    from fluidsolver_tpu_torch.ops import stencil
    from fluidsolver_tpu_torch.poisson import _kernels
    from fluidsolver_tpu_torch.solvers import twophase

    state = twophase.init_two_phase_state(g, cfg, vf0, torch.float32, device)
    vol0 = float(state.vf[1:-1, 1:-1].double().sum())
    step = twophase.make_step(g, cfg, torch.float32, device, mesh=mesh)
    torch.cuda.synchronize()

    _kernels.launches.clear()
    ms, iters, syncs, errs = [], [], [], []
    for _ in range(n_steps):
        s0 = sync.count
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        state = step(state, 1e9)
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        syncs.append(sync.count - s0)
        iters.append(int(state.flow.p_iter))
        errs.append(float(state.vof_vol_error))
    launches = dict(_kernels.launches)
    if syncs_out is not None:
        syncs_out.extend(syncs)

    vf = state.vf[1:-1, 1:-1]
    finite = all(bool(torch.isfinite(t).all()) for t in
                 (state.flow.U, state.flow.V, state.flow.p, state.vf, state.curv))
    div = stencil.divergence(state.flow.U, state.flow.V, g.dx, g.dy)[1:-1, 1:-1]
    drift = (float(vf.double().sum()) - vol0) / vol0
    vf_min, vf_max = float(vf.min()), float(vf.max())
    log(f"  launches in {n_steps} steps: {launches}")
    first = 4 if n_steps >= 4 else 1
    log(f"  ms/step (CUDA events; median of steps {first}-{n_steps}): {statistics.median(ms[first - 1:]):.4f}; "
        f"all steps: {[round(v, 3) for v in ms]}")
    log(f"  p_iter per step: {iters} (sum {sum(iters)})")
    log(f"  host syncs per step: {syncs}")
    log(f"  vof_vol_error per step: {['%.3e' % e for e in errs]}")
    log(f"  vf in [{vf_min:.9f}, {vf_max:.9f}]; relative drift of sum(vf) over {n_steps} steps {drift:.3e}; "
        f"max|div| {float(div.abs().max()):.3e}; t = {float(state.flow.t):.6f}")
    require(finite, "non-finite U, V, p, vf or curv")
    require(all(math.isfinite(e) for e in errs), "vof_vol_error is not finite")
    require(vf_min >= -1e-5 and vf_max <= 1.0 + 1e-5, "vf left [-1e-5, 1 + 1e-5]")
    require(all(1 + i <= s <= 1 + i + cfg.num_subiter for s, i in zip(syncs, iters)),
            "host syncs per step should be 1 (dt > 0) + one PCG exit test per iteration and solve")
    return step, state, launches, iters


def profile_bench(step, state, n: int, kernels) -> tuple:
    """Profile ``n`` more steps: the wall and device time, the idle share, the
    device time of ``kernels``, of the VOF stage and the pressure solves, and
    the device time by kernel."""
    from fluidsolver_tpu_torch.poisson import _kernels, cg
    from fluidsolver_tpu_torch.solvers import twophase

    holder = [state]

    def one():
        holder[0] = step(holder[0], 1e9)

    _kernels.launches.clear()
    by_name, busy, wall_us, ranges = profile_steps(one, n)
    ours = {k: by_name.get(k, (0.0, 0)) for k in kernels}
    calls = dict(_kernels.launches)
    vof_total = ranges.get(twophase.VOF_RANGE, 0.0)
    pressure_total = ranges.get(twophase.PRESSURE_RANGE, 0.0)
    guards = ranges.get(cg.GUARD_RANGE, 0.0)
    vof_kernels = sum(ours[k][0] for k in ("elvira", "curvature", "overlap"))
    log(f"  {n} profiled steps: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
        f"idle share {1 - busy / wall_us:.3f}")
    log(f"    fused PCG kernels {sum(ours[k][0] for k in FUSED[:3]) / 1e3:.4f} ms "
        f"({sum(ours[k][1] for k in FUSED[:3])} launches); fused momentum "
        f"{ours['fused_momentum'][0] / 1e3:.4f} ms ({ours['fused_momentum'][1]} launches); fused RHS "
        f"{ours['fused_rhs'][0] / 1e3:.4f} ms ({ours['fused_rhs'][1]} launches)")
    log(f"    VOF kernels {vof_kernels / 1e3:.4f} ms; rest of the VOF stage "
        f"{(vof_total - vof_kernels) / 1e3:.4f} ms; pressure solves (with the hierarchy) "
        f"{pressure_total / 1e3:.4f} ms (of it the PCG loop's guard selects {guards / 1e3:.4f}); other work "
        f"{(busy - vof_total - pressure_total) / 1e3:.4f} ms")
    log("    " + "; ".join(f"{k} {ours[k][0] / 1e3:.4f} ms in {ours[k][1]} device kernels for {calls.get(k, 0)} calls, "
                          f"{ours[k][0] / 1e3 / max(calls.get(k, 0), 1):.5f} ms per call (in path)"
                          for k in ONE_LAUNCH if k in kernels))
    require(all(ours[k][1] == calls.get(k, 0) > 0 for k in ONE_LAUNCH if k in kernels),
            f"{', '.join(k for k in ONE_LAUNCH if k in kernels)} must each be one device kernel per call")
    log("    device time by kernel (ms, launches):")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:14]:
        log(f"    {t / 1e3:9.4f}  {c:5d}  {name}")
    return by_name, busy


# Σp_iter of the f32 bench step as recorded since PR 3 (PERF.md; NVIDIA H100
# 80GB HBM3, 700 W): 20 steps on BoxMG (phase 6), 10 on "mg" (phase 7). The
# dense coarsest inverse of the other hierarchies leaves the f32 path as it was.
RECORDED_P_ITER = {"boxmg": 598, "mg": 1735}


def bench_phase(device, g, cfg, vf0) -> dict:
    """20 steps of the bench configuration (BoxMG); returns the launch counts."""
    n_steps = 20
    step, state, launches, iters = drive_bench(device, g, cfg, vf0, n_steps)
    for name in BOXMG_STEP:
        require(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    n_above = above_tail_levels(g.shape_center)
    solves = n_steps * cfg.num_subiter
    cycles = sum(iters) + solves
    expected = {"elvira": n_steps, "curvature": n_steps, "overlap": n_steps,
                "fused_rap": n_above * n_steps, "tail_setup": n_steps,
                "tail_cycle": cycles, "fused_smooth": 2 * n_above * cycles,
                # one step_ab per PCG iteration, one step_init and one
                # init-form step_c per solve, one fused_momentum and one
                # fused_rhs per subiteration
                "step_ab": sum(iters), "step_c": sum(iters) + solves, "step_init": solves,
                "fused_momentum": solves, "fused_rhs": solves, "rb_sweep": 0}
    log(f"  expected launches: {expected}; Σp_iter {sum(iters)} (recorded {RECORDED_P_ITER['boxmg']})")
    require(sum(iters) == RECORDED_P_ITER["boxmg"], f"Σp_iter {sum(iters)} differs from the recorded "
            f"{RECORDED_P_ITER['boxmg']}: the f32 BoxMG path changed")
    require(all(launches.get(k, 0) == v for k, v in expected.items()),
            "the launch counts differ from one VOF kernel each, one hierarchy per step, one V-cycle, "
            "step_ab and step_c per PCG iteration, and one step_init, step_c, V-cycle, "
            "fused_momentum and fused_rhs per solve")
    profile_bench(step, state, 3, BOXMG_STEP)
    return launches


# ---- phase 7 ---------------------------------------------------------------
def mg_bench_phase(device, g, cfg, vf0) -> dict:
    """10 steps of the bench configuration on PCG + "mg"; returns the launch
    counts. Every pressure solve is recorded (iterations, residual, its
    tolerance) to report the solves that stopped at the iteration cap or on
    the stagnation window; the residuals are read after the steps."""
    from fluidsolver_tpu_torch.poisson import mg
    from fluidsolver_tpu_torch.poisson.linsys import StencilOp

    n_steps = 10
    meta = torch.empty(g.shape_center, device="meta")
    levels = mg.build_hierarchy(StencilOp(*(meta,) * 5))
    sweeps = (len(levels) - 1) * (cfg.mg_pre + cfg.mg_post) + mg.COARSE_SWEEPS
    log(f"  mg hierarchy: {len(levels)} levels, sides {[lv.aC.shape[0] for lv in levels]}; "
        f"{sweeps} sweeps per V({cfg.mg_pre},{cfg.mg_post}) cycle")

    solves = []
    with recorded_solves(solves):
        step, state, launches, iters = drive_bench(device, g, cfg, vf0, n_steps)
    n_solves = len(solves)
    log_solve_exits(solves, cfg)
    require(n_solves == n_steps * cfg.num_subiter, f"{n_solves} pressure solves in {n_steps} steps")
    cycles = sum(iters) + n_solves
    expected = {"rb_sweep": cycles * sweeps, "elvira": n_steps, "curvature": n_steps, "overlap": n_steps,
                "step_ab": sum(iters), "step_c": cycles, "step_init": n_solves, "fused_momentum": n_solves,
                "fused_rhs": n_solves, **{k: 0 for k in BOXMG}}
    log(f"  expected launches: {expected}; Σp_iter {sum(iters)} (recorded {RECORDED_P_ITER['mg']})")
    require(sum(iters) == RECORDED_P_ITER["mg"], f"Σp_iter {sum(iters)} differs from the recorded "
            f"{RECORDED_P_ITER['mg']}: the f32 \"mg\" path changed")
    require(all(launches.get(k, 0) == v for k, v in expected.items()),
            f"the launch counts differ from {sweeps} rb_sweep launches per V-cycle (one per PCG "
            "iteration and one per solve), the PCG and momentum kernels per iteration and solve, "
            "one VOF kernel each per step and no BoxMG kernel")
    profile_bench(step, state, 2, MG_STEP)
    return launches


# ---- phase 8 ---------------------------------------------------------------
def event():
    e = torch.cuda.Event(enable_timing=True)
    e.record()
    return e


def step_ms(events: list) -> list:
    torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in zip(events, events[1:])]


def state_tensors(state) -> dict:
    out = {f"flow.{f.name}": getattr(state.flow, f.name) for f in dataclasses.fields(state.flow)}
    out.update({f.name: getattr(state, f.name) for f in dataclasses.fields(state) if f.name != "flow"})
    return out


def driver_channel_phase(device) -> None:
    """(a) ``Simulation`` on two_phase_channel(ny=448) (2240 x 448, f32,
    VTK frames), 10 steps from one initial state, in turns with 10 bare
    step calls (bare, driver, driver, bare): the same state bit for bit,
    the bare loop's host syncs plus one a step and one a frame, the same
    kernel launches; ms/step of both and ms per frame."""
    from fluidsolver_tpu_torch import driver
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.core import sync
    from fluidsolver_tpu_torch.io.writer import SaveCadence
    from fluidsolver_tpu_torch.poisson import _kernels

    n_steps = 10
    case = get_case("two_phase_channel", ny=448)
    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        sim = driver.Simulation(case, output_dir=out, writer="vtk", device=device)
        log(f"  Simulation set-up ({case.grid.nx} x {case.grid.ny}, f32): {time.perf_counter() - t0:.1f} s; "
            f"writer {type(sim.writer).__name__}")
        require(sim.dtype == torch.float32, "the driver's default dtype must be float32")
        state0 = sim.state
        step = case.make_step(torch.float32, device)

        def bare():
            _kernels.launches.clear()
            s0 = sync.count
            state, events, times = state0, [event()], []
            for _ in range(n_steps):
                state = step(state, case.t_end)
                events.append(event())
                times.append((state.flow.t, state.flow.dt))
            syncs = sync.count - s0
            launches = dict(_kernels.launches)
            return state, launches, syncs, step_ms(events), [(float(t), float(dt)) for t, dt in times]

        frame_ms = []
        write = sim.writer.write

        def timed_write(t):
            t1 = time.perf_counter()
            path = write(t)
            frame_ms.append((time.perf_counter() - t1) * 1e3)
            return path

        sim.writer.write = timed_write

        def run_driver(bare_state, bare_launches, bare_syncs, restart: bool):
            if restart:
                sim.state = state0
            n_frames = len(frame_ms)
            _kernels.launches.clear()
            s0 = sync.count
            events = [event()]
            sim.run(max_steps=n_steps, callback=lambda s: events.append(event()))
            syncs = sync.count - s0
            launches = dict(_kernels.launches)
            frames = len(frame_ms) - n_frames
            for f in os.listdir(out):
                if f.endswith(".vtk"):
                    os.remove(os.path.join(out, f))
            log(f"  driver run: {sim.n_steps} steps, {frames} frames, host syncs {syncs} "
                f"(bare {bare_syncs} + {n_steps} + {frames} frames{' + 1: the state was set' if restart else ''})")
            require(sim.n_steps == n_steps, f"the driver ran {sim.n_steps} steps")
            require(frames == expected_frames, f"{frames} frames written, expected {expected_frames}")
            require(syncs == bare_syncs + n_steps + frames + restart,
                    "the driver must add exactly one host sync a step and one a frame to the bare steps'")
            require(launches == bare_launches, f"driver launches {launches} differ from the bare loop's "
                    f"{bare_launches}")
            bare_t = state_tensors(bare_state)
            for k, t in state_tensors(sim.state).items():
                require(torch.equal(t, bare_t[k]), f"the driver's {k} is not the bare loop's")
            return step_ms(events)

        b1 = bare()
        log(f"  bare loop: host syncs {b1[2]}, launches {b1[1]}")
        require(all(b1[1].get(k, 0) > 0 for k in BOXMG_STEP), "a kernel of the BoxMG step was not launched")
        # the first frame after the initial one falls at step 5
        sim.case.dt_write = b1[4][4][0]
        cadence = SaveCadence(sim.case.dt_write, case.t_end)
        expected_frames = 1 + sum(cadence(t, dt) for t, dt in b1[4])
        require(expected_frames >= 2, "dt_write must give at least two frames")
        d1 = run_driver(*b1[:3], restart=False)
        d2 = run_driver(*b1[:3], restart=True)
        b2 = bare()
        require(b2[2] == b1[2] and b2[1] == b1[1], "the second bare run differs from the first")
        bare_t = state_tensors(b1[0])
        require(all(torch.equal(t, bare_t[k]) for k, t in state_tensors(b2[0]).items()),
                "the second bare run's state differs from the first")
        sim.close()
    med = {name: statistics.median(ms[1:]) for name, ms in
           (("bare 1", b1[3]), ("driver 1", d1), ("driver 2", d2), ("bare 2", b2[3]))}
    log("  ms/step (CUDA events, median of steps 2-10), in turns: "
        + ", ".join(f"{k} {v:.4f}" for k, v in med.items()))
    log(f"  driver / bare: {(med['driver 1'] + med['driver 2']) / (med['bare 1'] + med['bare 2']):.4f}; "
        f"all steps: bare 1 {[round(v, 3) for v in b1[3]]}, driver 1 {[round(v, 3) for v in d1]}")
    log(f"  ms per VTK frame (host wall: one copy of the 8 planes, the file): "
        f"{[round(v, 1) for v in frame_ms]}, median {statistics.median(frame_ms):.1f}")


def driver_cli_phase(device) -> None:
    """(b) ``driver.main`` on stationary_drop(n=256), f32, a few steps, VTK,
    under ``--profile``: the monitor has a row per step and one more, and
    the trace holds the pressure solve's range."""
    from fluidsolver_tpu_torch import driver
    from fluidsolver_tpu_torch.io.monitor_parse import read_monitor_file
    from fluidsolver_tpu_torch.solvers import twophase
    from fluidsolver_tpu_torch.utils.profiling import TRACE_FILE

    with tempfile.TemporaryDirectory() as out:
        t0 = time.perf_counter()
        sim = driver.main(["stationary_drop", "--param", "n=256", "--t-end", "0.005", "--writer", "vtk",
                           "--output", out, "--profile", os.path.join(out, "trace"), "--log-every", "1"])
        wall = time.perf_counter() - t0
        rows = read_monitor_file(os.path.join(out, "monitor.log"))
        trace = Path(out, "trace", TRACE_FILE)
        size = trace.stat().st_size
        has_range = twophase.PRESSURE_RANGE in trace.read_text()
        frames = sorted(f for f in os.listdir(out) if f.endswith(".vtk"))
    log(f"  main: {sim.n_steps} steps on {sim.device} ({sim.dtype}) in {wall:.1f} s with the profiler; "
        f"{len(rows['time'])} monitor rows, {len(frames)} frames, trace {size / 2**20:.1f} MiB")
    require(sim.device.type == "cuda" and sim.dtype == torch.float32, "main must run on the card in f32")
    require(sim.n_steps >= 2 and len(rows["time"]) == sim.n_steps + 1, "the monitor needs n_steps + 1 rows")
    require(all(np.isfinite(v).all() for v in rows.values()), "non-finite monitor values")
    require(has_range, f"the trace has no {twophase.PRESSURE_RANGE} range")


def driver_kinematic_phase(device) -> None:
    """(c) ``Simulation`` on vof_tgv(n=1024), f64, 20 kinematic steps: the
    reference's Taylor-Green invariants, one elvira and one overlap launch a
    step and no other kernel, one host sync a step; the bare step queued
    behind a device sleep returns with the stream busy (no host read)."""
    from fluidsolver_tpu_torch import driver
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.core import sync
    from fluidsolver_tpu_torch.poisson import _kernels

    n_steps = 20
    case = get_case("vof_tgv", n=1024)
    sim = driver.Simulation(case, dtype=torch.float64, device=device, save_output=False)
    vf = sim.state.vf
    init = torch.sum(vf)
    stats, marks = [], [sync.count]
    events = [event()]

    def stash(state):
        marks.append(sync.count)
        events.append(event())
        vf = state.vf
        stats.append(torch.stack([state.vof_vol_error, vf.min(), vf.max(), torch.sum(vf)]))

    _kernels.launches.clear()
    sim.run(max_steps=n_steps, callback=stash)
    launches = dict(_kernels.launches)
    ms = step_ms(events)
    stats = torch.stack(stats).cpu().numpy()
    dx, dy = case.grid.dx, case.grid.dy
    mass = np.abs(stats[:, 3] - float(init)) * dx * dy
    log(f"  {sim.n_steps} steps to t = {sim.observe()['time']:.6f}: launches {launches}; host syncs per step "
        f"{np.diff(marks).tolist()}")
    log(f"  ms/step (CUDA events, median of steps 2-{n_steps}): {statistics.median(ms[1:]):.4f}; "
        f"all steps: {[round(v, 3) for v in ms]}")
    log(f"  max vof_vol_error {stats[:, 0].max():.3e}; vf in [{stats[:, 1].min():.3e}, 1 + "
        f"{stats[:, 2].max() - 1:.3e}]; max |mass drift| {mass.max():.3e}")
    require(sim.n_steps == n_steps, f"{sim.n_steps} kinematic steps")
    require(launches == {"elvira": n_steps, "overlap": n_steps},
            "the kinematic step must launch elvira and overlap once a step and no other kernel")
    require(np.diff(marks).tolist() == [1] * n_steps, "the driver must make one host sync a kinematic step")
    require(stats[:, 0].max() < 1e-12, "a step's volume error is not below 1e-12")
    require(np.abs(stats[:, 1]).max() <= 1e-8 and np.abs(stats[:, 2] - 1.0).max() <= 1e-8,
            "vf left [0, 1] by more than 1e-8")
    require(mass.max() <= 1e-10, "the liquid volume drifted by more than 1e-10")

    step = sim.step
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    step(sim.state, case.t_end)
    pending = not torch.cuda.current_stream(device).query()
    torch.cuda.synchronize()
    log(f"  the kinematic step queued behind a device sleep: stream still busy on return: {pending}")
    require(pending, "the kinematic step drained the stream (a host read)")


# ---- phase 4e ----------------------------------------------------------------
# the two-phase options of phase 9 on two_phase_channel(ny=16)
CHANNEL_OPTIONS = (("tangent_force", dict(surface_tension_method="tangent_force")),
                   ("regression", dict(curvature_method="regression")),
                   ("convolved", dict(curvature_method="convolved")),
                   ("dense", dict(vof_max_active=0)),
                   ("no_correction", dict(vof_no_correction=True)),
                   ("staggered", dict(vof_staggered_backtrace=True)))
# the immersed-boundary cases: (label, case, its arguments but the size)
IB_CASES = (("diffuse", "diffuse_ib_channel", {}),
            ("sharp quadratic", "sharp_ib_channel", dict(scheme="quadratic")),
            ("luchini", "luchini_ib_channel", {}),
            ("luchini implicit", "luchini_ib_channel", dict(implicit=True)),
            ("growing_ib", "growing_ib", {}))


def cross_check_case(device, case, n_steps: int, what: str) -> None:
    """``case`` through the driver on the card and on the CPU, f64, tol
    1e-11 (1e-9 on the intermediate subiterations): every observed column
    within 1e-9 of its scale and iter(p) within 1 a step (check_rows), the
    final U, V, p (and vf) within 1e-9."""
    from fluidsolver_tpu_torch import driver

    case.cfg = dataclasses.replace(case.cfg, pressure_tol=1e-11, pressure_tol_intermediate=1e-9)
    runs = []
    for dev in (device, torch.device("cpu")):
        sim = driver.Simulation(case, dtype=torch.float64, device=dev, save_output=False)
        rows = driver_rows(sim, max_steps=n_steps)
        fl = sim.state.flow if case.two_phase else sim.state
        final = {k: getattr(fl, k).cpu().numpy() for k in ("U", "V", "p")}
        if case.two_phase:
            final["vf"] = sim.state.vf.cpu().numpy()
        runs.append((rows, final, sim.n_steps))
    (g_rows, g, g_n), (c_rows, c, c_n) = runs
    require(g_n == c_n == n_steps, f"{what}: {g_n}, {c_n} steps")
    log(f"  {what}: iter(p) per step gpu {[int(r['iter(p)']) for r in g_rows[1:]]}, "
        f"cpu {[int(r['iter(p)']) for r in c_rows[1:]]}")
    check_rows(g_rows, c_rows, 1e-9, case.grid.dx, case.cfg.pressure_tol)
    rels = {k: float(np.abs(g[k] - c[k]).max() / (np.abs(c[k]).max() or 1.0)) for k in g}
    log(f"  {what}: final max|gpu - cpu| / max|cpu|: " + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
    require(all(v <= 1e-9 for v in rels.values()), f"{what} f64: a final field differs by more than 1e-9")


def options_cross_check_phase(device) -> None:
    """Phase 4e: GPU against CPU in f64 for two_phase_channel(ny=16) with
    each of CHANNEL_OPTIONS, expanding_bubble(n=32), the four IB channels
    and growing_ib at ny=16, 3 steps each. The convolved curvature runs at
    ny=32: at ny=16 the drop's radius is 1.8 cells, so the bilinear sample
    at its interface reaches the drop's centre, where the smoothed
    gradient vanishes and |grad|^3 crosses the estimator's 1e-8 cut; there
    one rounding decides the sample (the JAX package's jitted and
    op-by-op runs differ by 12% of the largest curvature at ny=16, by
    9e-16 at ny=32)."""
    from fluidsolver_tpu_torch.cases import get_case

    for label, change in CHANNEL_OPTIONS:
        case = get_case("two_phase_channel", ny=32 if label == "convolved" else 16)
        case.cfg = dataclasses.replace(case.cfg, **change)
        cross_check_case(device, case, 3, f"two_phase_channel({case.grid.ny}) {label}")
    cross_check_case(device, get_case("expanding_bubble", n=32), 3, "expanding_bubble(32)")
    for label, name, kw in IB_CASES:
        cross_check_case(device, get_case(name, ny=16, **kw), 3, f"{name}(16) {label}")


# ---- phase 9 -------------------------------------------------------------------
# (label, config change, steps)
BENCH_OPTIONS = tuple((label, change, 2 if label == "dense" else 5) for label, change in CHANNEL_OPTIONS)


def expected_bench_launches(n_steps: int, iters: list, n_above: int, n_subiter: int) -> dict:
    """The launches of the BoxMG bench step (see bench_phase)."""
    solves = n_steps * n_subiter
    cycles = sum(iters) + solves
    return {"elvira": n_steps, "curvature": n_steps, "overlap": n_steps, "overlap_n0_4": 0,
            "fused_rap": n_above * n_steps, "tail_setup": n_steps, "tail_cycle": cycles,
            "fused_smooth": 2 * n_above * cycles, "step_ab": sum(iters), "step_c": sum(iters) + solves,
            "step_init": solves, "fused_momentum": solves, "fused_rhs": solves, "rb_sweep": 0}


def record_advections(device, g, cfg, vf0, dtype, n_steps: int) -> list:
    """The arguments of the advection in each of the first ``n_steps`` steps
    of ``cfg`` from ``vf0``, recorded at ``vof.advect.advect``."""
    from fluidsolver_tpu_torch.solvers import twophase
    from fluidsolver_tpu_torch.vof import advect

    calls = []
    original = advect.advect

    def recording(*args, **kw):
        calls.append((args, kw))
        return original(*args, **kw)

    advect.advect = recording
    try:
        state = twophase.init_two_phase_state(g, cfg, vf0, dtype, device)
        step = twophase.make_step(g, cfg, dtype, device)
        for _ in range(n_steps):
            state = step(state, 1e9)
    finally:
        advect.advect = original
    require(len(calls) == n_steps, f"{len(calls)} advections in {n_steps} steps")
    return calls


def dense_oracle_check(device, g, cfg, vf0) -> None:
    """The dense advection against the sparse one (kernel #12) on the
    advection inputs of the bench configuration's steps 1 and 2, f64 at
    1024^2: max |vf_dense - vf_sparse| <= 1e-12 (the level of
    tests/test_vof_advect.py), with the dense path's peak memory."""
    from fluidsolver_tpu_torch.poisson import _kernels
    from fluidsolver_tpu_torch.vof import advect

    for k, (args, kw) in enumerate(record_advections(device, g, cfg, vf0, torch.float64, 2)):
        _kernels.launches.clear()
        vf_s, err_s = advect.advect(*args, **kw)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        base = torch.cuda.memory_allocated(device)
        vf_d, err_d = advect.advect(*args, **{**kw, "max_active": 0})
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(device) - base
        launches = dict(_kernels.launches)
        diff = float((vf_d - vf_s).abs().max())
        moved = float((vf_s - args[0]).abs().max())
        log(f"  step {k + 1}'s advection, f64 1024^2: max|vf dense - vf sparse| = {diff:.3e} (vf moved by up to "
            f"{moved:.3e}); volume errors dense {float(err_d):.3e}, sparse {float(err_s):.3e}; launches "
            f"{launches}; the dense path's peak memory above its inputs {peak / 2**30:.2f} GiB")
        require(diff <= 1e-12, f"dense against sparse advection at step {k + 1}: {diff:.3e} > 1e-12")
        require(launches == {"overlap": 1}, "the sparse advection must launch overlap once, the dense one nothing")


def bench_options_phase(device, g, cfg, vf0) -> int:
    """Phase 9: BENCH_OPTIONS on the bench configuration (1024^2, f32,
    BoxMG, refresh "step"): drive_bench's report and the exact launches;
    no curvature launch under regression or convolved, no overlap launch on
    the dense path (with its peak memory), one quad overlap launch a step
    under no_correction; then dense_oracle_check. Returns the quad
    launches."""
    n_above = above_tail_levels(g.shape_center)
    quad = 0
    for label, change, n_steps in BENCH_OPTIONS:
        log(f"  {label} ({change}), {n_steps} steps:")
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        _, _, launches, iters = drive_bench(device, g, dataclasses.replace(cfg, **change), vf0, n_steps)
        log(f"  {label}: peak device memory {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB")
        expected = expected_bench_launches(n_steps, iters, n_above, cfg.num_subiter)
        if label in ("regression", "convolved"):
            expected["curvature"] = 0
        if label == "dense":
            expected["overlap"] = 0
        if label == "no_correction":
            expected["overlap_n0_4"] = n_steps
            quad = launches.get("overlap_n0_4", 0)
        if label == "tangent_force":
            expected["fused_rhs"] = 0
        require(all(launches.get(k, 0) == v for k, v in expected.items()),
                f"{label}: the launch counts differ from {expected}")
    dense_oracle_check(device, g, cfg, vf0)
    return quad


# ---- phase 10 ------------------------------------------------------------------
def drive_case(device, case, n_steps: int, dtype=torch.float32):
    """``n_steps`` bare steps of ``case`` from its initial state, each timed
    by CUDA events, with the launch counts set to 0 just before the first
    step and read just after the last. Returns (initial state, state, ms,
    p_iter, host syncs, launches) per step."""
    from fluidsolver_tpu_torch.core import sync
    from fluidsolver_tpu_torch.poisson import _kernels

    state = state0 = case.make_state(dtype, device)
    step = case.make_step(dtype, device)
    torch.cuda.synchronize()
    _kernels.launches.clear()
    ms, iters, syncs = [], [], []
    for _ in range(n_steps):
        s0 = sync.count
        start = event()
        state = step(state, 1e9)
        end = event()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
        syncs.append(sync.count - s0)
        iters.append(int((state.flow if case.two_phase else state).p_iter))
    return state0, state, ms, iters, syncs, dict(_kernels.launches)


def expanding_bubble_phase(device) -> None:
    """Phase 10: expanding_bubble(n=1024, m_dot=1), f32, 10 steps: ms/step,
    launches, vf bounds, and the gas area's growth above 0.3 of 2 pi r
    m_dot t (tests/test_sources.py)."""
    from fluidsolver_tpu_torch.cases import get_case

    n_steps = 10
    case = get_case("expanding_bubble", n=1024, m_dot=1.0)
    g = case.grid
    state0, state, ms, iters, syncs, launches = drive_case(device, case, n_steps)
    gas0 = float((1.0 - state0.vf[1:-1, 1:-1].double()).sum()) * g.dx * g.dy
    vf = state.vf[1:-1, 1:-1].double()
    gas1 = float((1.0 - vf).sum()) * g.dx * g.dy
    t = float(state.flow.t)
    expected = 2.0 * math.pi * 0.15 * 1.0 * t
    finite = all(bool(torch.isfinite(x).all()) for x in (state.flow.U, state.flow.V, state.flow.p, state.vf))
    log(f"  launches in {n_steps} steps: {launches}")
    log(f"  ms/step (CUDA events; median of steps 2-{n_steps}): {statistics.median(ms[1:]):.4f}; all steps: "
        f"{[round(v, 3) for v in ms]}")
    log(f"  p_iter per step: {iters} (sum {sum(iters)}); host syncs per step: {syncs}")
    log(f"  t = {t:.6f}: gas area {gas0:.6e} -> {gas1:.6e}, growth {gas1 - gas0:.4e} against 2 pi r m_dot t = "
        f"{expected:.4e} (ratio {(gas1 - gas0) / expected:.4f}); vf in [{float(vf.min()):.3e}, "
        f"{float(vf.max()):.9f}]")
    require(finite, "non-finite U, V, p or vf")
    require(gas1 - gas0 > 0.3 * expected, "the bubble grew by less than 0.3 of 2 pi r m_dot t")
    require(float(vf.min()) > -1e-5 and float(vf.max()) < 1.0 + 1e-5, "vf left [-1e-5, 1 + 1e-5]")
    require(launches.get("elvira") == n_steps and launches.get("overlap") == n_steps
            and launches.get("curvature") == n_steps and launches.get("fused_momentum") == n_steps * 5
            and launches.get("fused_rhs") == n_steps * 5,
            "one elvira, overlap and curvature a step and one fused_momentum and fused_rhs a subiteration")


# ---- phase 11 ------------------------------------------------------------------
def ib_case_phase(device, label: str, name: str, kw: dict, ny: int, checked: bool = True) -> tuple:
    """One IB case through the driver, f32, 10 steps: the field set-up time
    (make_step, with the hierarchy), ms/step, p_iter, host syncs a step (the
    bare step's + 1), the launches of kernels 1-7 (fused_rap and tail_setup
    once at make_step, none a step), and, if ``checked``, no NaN, |U| deep
    in the solid below 0.15 and max|div| below 1e-3 (tests/test_ib.py); the
    speed through the gap over the cylinder is logged. Returns the final
    state and the case."""
    from fluidsolver_tpu_torch import driver
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.core import sync
    from fluidsolver_tpu_torch.ops import stencil
    from fluidsolver_tpu_torch.poisson import _kernels

    n_steps = 10
    case = get_case(name, ny=ny, **kw)
    g = case.grid
    make_step = case.make_step
    setup = {}

    def timed_make_step(dtype, dev):
        torch.cuda.synchronize()
        _kernels.launches.clear()
        t0 = time.perf_counter()
        step = make_step(dtype, dev)
        torch.cuda.synchronize()
        setup.update(s=time.perf_counter() - t0, launches=dict(_kernels.launches))
        return step

    case.make_step = timed_make_step
    sim = driver.Simulation(case, dtype=torch.float32, device=device, save_output=False)
    marks, events, iters = [sync.count], [event()], []

    def stash(state):
        marks.append(sync.count)
        events.append(event())
        iters.append(int(sim.observe()["iter(p)"]))

    bare = []
    step = sim.step

    def counting(state, t_end):
        s0 = sync.count
        out = step(state, t_end)
        bare.append(sync.count - s0)
        return out

    sim.step = counting
    _kernels.launches.clear()
    sim.run(max_steps=n_steps, callback=stash)
    launches = dict(_kernels.launches)
    ms = step_ms(events)
    state = sim.state
    U = state.U.float().cpu().numpy()
    div = stencil.divergence(state.U, state.V, g.dx, g.dy)[1:-1, 1:-1]
    wall, div_scale, offset = case.meta.get("wall"), 1.0, 0.0
    if wall is None:
        # growing_ib: the circle at its radius now. The projection leaves
        # div = ib (3/r) drdt, the source of the last step's start, less a
        # constant: the pressure problem is singular (no pin), so the
        # solve removes the mean, which no outflow balances. What is left
        # is held against the source's scale (3 drdt / r) as the channels'
        # divergence is held against 1
        r0, drdt = case.meta["r0"], case.meta["drdt"]
        wall = dataclasses.make_dataclass("W", ["x", "y", "r"])(
            case.meta["cx"], case.meta["cy"], r0 + drdt * float(state.t))
        t_old = state.t - state.dt
        ib = case.ib_builder(g, torch.float32, device)(dataclasses.replace(state, t=t_old)).ib
        source = ib * (3.0 / (r0 + drdt * t_old)) * drdt
        div = div - source[1:-1, 1:-1]
        offset = float(div.double().mean())
        div, div_scale = div - offset, float(source.abs().max())
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    deep = (Xu - wall.x) ** 2 + (Yu - wall.y) ** 2 < (0.5 * wall.r) ** 2
    u_deep = float(np.abs(U[deep]).max())
    u_gap = float(np.abs(U[int((wall.x - g.x_min) / g.dx) + 1, :]).max())
    nan = bool(np.isnan(U).any())
    n_above = above_tail_levels(g.shape_center)
    solves = n_steps * case.cfg.num_subiter
    log(f"  {label} ({name}, ny={ny}, {g.nx} x {g.ny}): set-up (IB fields and hierarchy) {setup['s']:.3f} s, "
        f"launches there {setup['launches']}")
    log(f"    launches in {sim.n_steps} driver steps: {launches}")
    log(f"    ms/step (CUDA events; median of steps 2-{sim.n_steps}): {statistics.median(ms[1:] or ms):.4f}; "
        f"all steps: "
        f"{[round(v, 3) for v in ms]}")
    log(f"    p_iter per step {iters} (sum {sum(iters)}); host syncs per driver step {np.diff(marks).tolist()}, "
        f"of the bare step {bare}")
    log(f"    NaN in U: {nan}; max|U| deep in the solid {u_deep:.4e}; max|div| (growing_ib: less the source and "
        f"its mean {offset:.4e}, over the source's scale {div_scale:.4f}) {float(div.abs().max()) / div_scale:.3e}; "
        f"gap speed {u_gap:.4f}; t = {float(state.t):.6f}")
    require(setup["launches"].get("tail_setup") == 1 and setup["launches"].get("fused_rap", 0) == n_above,
            f"{label}: make_step must build one hierarchy (tail_setup once, fused_rap {n_above} times)")
    require(launches.get("fused_rap", 0) == 0 and launches.get("tail_setup", 0) == 0,
            f"{label}: a step must not rebuild the hierarchy")
    require(np.diff(marks).tolist() == [b + 1 for b in bare], f"{label}: a driver step must cost the bare step + 1")
    if checked:
        require(sim.n_steps == n_steps and launches.get("step_init") == solves
                and launches.get("tail_cycle", 0) > 0 and launches.get("step_ab", 0) > 0
                and launches.get("fused_smooth", 0) > 0,
                f"{label}: {n_steps} steps, one step_init a solve, and the V-cycle and PCG kernels")
        require(not nan, f"{label}: NaN in U")
        require(u_deep < 0.15, f"{label}: |U| deep in the solid {u_deep:.3e} >= 0.15")
        require(float(div.abs().max()) < 1e-3 * div_scale, f"{label}: max|div| >= 1e-3 of its scale")
    return state, case


def ib_phase(device) -> None:
    """Phase 11: the IB cases at the bench's cell count (the channels at
    ny=448, 2240 x 448; growing_ib at ny=576, 1728 x 576), f32, 10 steps
    each; the sharp channel also with the linear weights, reported and not
    held (they diverge as beta -> 1; the driver stops at a NaN time). growing_ib's divergence is held less
    its source and their constant difference (the singular solve's),
    against the source's scale."""
    for label, name, kw in IB_CASES:
        ib_case_phase(device, label, name, kw, 576 if name == "growing_ib" else 448)
    ib_case_phase(device, "sharp linear", "sharp_ib_channel", dict(scheme="linear"), 448, checked=False)


# ---- phase 3e ------------------------------------------------------------------
BF16_ULP = 2.0 ** -8


def check_bf16(errors: Errors, name: str, got, want, main: bool, what: str, scale=None) -> bool:
    """A bf16 kernel's outputs against its twin's: within one bf16 ulp,
    2^-8 (|twin| + 1) elementwise, or 2^-8 of ``scale`` (a field's largest
    value); returns whether they are bitwise equal. The largest error at
    the main path's shapes goes into the kernels line as the bf16 form's."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for g, w in zip(got, want):
        require(g.dtype == w.dtype == torch.bfloat16, f"{name} {what}: outputs {g.dtype}, {w.dtype}")
        diff = (g.float() - w.float()).abs()
        lim = BF16_ULP * (w.float().abs() + 1.0) if scale is None else torch.full_like(diff, BF16_ULP * scale)
        worst = max(worst, float(diff.max()))
        require(bool((diff <= lim).all()), f"{name} {what}: max|kernel - twin| = {float(diff.max()):.3e} "
                f"exceeds one bf16 ulp")
    if main:
        errors.max_abs[name + "_bf16"] = max(errors.max_abs.get(name + "_bf16", 0.0), worst)
    return all(torch.equal(g, w) for g, w in zip(got, want))


def bf16_levels(shape, device) -> tuple:
    """The f32 BoxMG levels of the random jump operator of ``shape`` built
    without the tail, and the same hierarchy cast to bf16 (the bf16
    preconditioner's, boxmg.cast_hierarchy)."""
    from fluidsolver_tpu_torch.poisson import boxmg

    levels32 = boxmg.build_hierarchy(random_operator(*shape, seed=13, dtype=torch.float32, device=device),
                                     tail=False)
    return levels32, boxmg.cast_hierarchy(levels32, torch.bfloat16)


def smooth_forms(tr, x0, ec) -> dict:
    """fused_smooth's four forms with V(2,2)'s half-steps."""
    return {"plain": dict(x0=x0, colors=(False, True, False, True)),
            "residual": dict(colors=(True, False, True, False), residual=True),
            "restrict": dict(colors=(True, False, True, False), tr=tr, restrict=True),
            "ec": dict(x0=x0, colors=(False, True, False, True), tr=tr, ec=ec)}


def bf16_inputs(shape, coarse, seed: int, device) -> tuple:
    bf = torch.bfloat16
    return (random_field(shape, seed, torch.float32, device).to(bf),
            random_field(shape, seed + 1, torch.float32, device).to(bf),
            random_field(coarse, seed + 2, torch.float32, device).to(bf))


def bf16_mg_levels(shape, device) -> list:
    """The bf16 "mg" hierarchy of the random jump operator of ``shape``
    (the "mg" preconditioner's under pressure_precond_dtype="bfloat16":
    built from the bf16 operator)."""
    from fluidsolver_tpu_torch.poisson import boxmg, mg

    op32 = random_operator(*shape, seed=13, dtype=torch.float32, device=device)
    return mg.build_hierarchy(boxmg.cast_struct(op32, torch.bfloat16))


def bf16_sweep_cases(mg_levels, device) -> list:
    """rb_sweep's phase-3e inputs at every level of a bf16 "mg" hierarchy:
    a zero and a random x, both orders: [(level shape, op, x0, b, reverse)]."""
    out = []
    for lvl, op in enumerate(mg_levels):
        lshape = tuple(op.aC.shape)
        b = random_field(lshape, 900 + lvl, torch.float32, device).to(torch.bfloat16)
        for x0 in (torch.zeros_like(b), random_field(lshape, 950 + lvl, torch.float32, device).to(torch.bfloat16)):
            for reverse in (False, True):
                out.append((lshape, op, x0, b, reverse))
    return out


def bf16_smooth_cases(levels, device) -> list:
    """fused_smooth's four forms at every smoothed level of a bf16 BoxMG
    hierarchy: [(level index, level shape, form, op, b, kw)]."""
    out = []
    for lvl, level in enumerate(levels):
        if level.tr is None:
            continue
        lshape = tuple(level.op.aC.shape)
        b, x0, ec = bf16_inputs(lshape, tuple(level.tr.pW.shape), 800 + 3 * lvl, device)
        for fname, kw in smooth_forms(level.tr, x0, ec).items():
            out.append((lvl, lshape, fname, level.op, b, kw))
    return out


def bf16_limit_cases(device) -> list:
    """fused_smooth's 40 bf16 cases at the limits of its tiling (four
    levels, ten variants each): [(level name, variant, op, b, kw)]."""
    from fluidsolver_tpu_torch.poisson import boxmg, cuda_rap

    bf = torch.bfloat16
    fine32 = random_operator(389, 277, seed=19, dtype=torch.float32, device=device)
    small32 = random_operator(23, 19, seed=29, dtype=torch.float32, device=device)
    limit_ops = (("389x277 5-point", fine32), ("195x139 9-point", cuda_rap.fused_rap_twin(fine32)[1]),
                 ("37x29 5-point", random_operator(37, 29, seed=23, dtype=torch.float32, device=device)),
                 ("12x10 9-point", cuda_rap.fused_rap_twin(small32)[1]))
    out = []
    for name, op32 in limit_ops:
        tr32 = cuda_rap.fused_rap_twin(op32)[0]
        op, tr = boxmg.cast_struct(op32, bf), boxmg.cast_struct(tr32, bf)
        shape = tuple(op.aC.shape)
        b, x0, ec = bf16_inputs(shape, tuple(tr.pW.shape), 410, device)
        cases = {f"V(1,1) {k}": kw for k, kw in smooth_variants(tr, x0, ec, 1, 1).items()}
        cases.update({f"V(2,2) {k}": kw for k, kw in smooth_forms(tr, x0, ec).items()})
        cases.update({
            "6 half-steps + restrict": dict(colors=(True, False) * 3, tr=tr, restrict=True),
            "7 half-steps + residual": dict(x0=x0, colors=(False, True) * 3 + (False,), residual=True),
            "8 half-steps ec": dict(x0=x0, colors=(False, True) * 4, tr=tr, ec=ec),
            "sweep pair": dict(x0=x0, colors=(True, False, False, True)),
        })
        out.extend((name, what, op, b, kw) for what, kw in cases.items())
    return out


def bf16_phase(device, errors: Errors) -> dict:
    """Phase 3e: the bf16 forms of kernels #1 and #9 against their twins,
    bitwise (torch.equal, required; the largest difference is also held
    to one bf16 ulp and reported). fused_smooth (bf16 storage, f32
    arithmetic) in its four forms at every level above the coarsest of the
    bf16 BoxMG hierarchies of the 1026^2 and 1023 x 771 boxes and at the
    limits of its tiling; rb_sweep (every operation in bf16) at every level
    of the bf16 "mg" hierarchies of both boxes, both orders, from a zero
    and a random x. Times: each level's two V-cycle launches in bf16 beside
    the f32 kernel on the uncast level, and rb_sweep bf16 beside f32 at
    1026^2, each with its bound (the bf16 bytes, f32 operations). Returns
    name -> (kernel ms, twin ms, bound ms, bound by) of the bf16 forms at
    the main path's shapes."""
    from fluidsolver_tpu_torch.poisson import cuda_smoother, cuda_vcycle

    bf = torch.bfloat16
    times = {}
    for shape, main in (((1026, 1026), True), ((1023, 771), False)):
        tag = f"bf16 {shape[0]}x{shape[1]}"
        levels32, levels = bf16_levels(shape, device)
        rows, n_cases = [], 0
        for lvl, lshape, fname, op, b, kw in bf16_smooth_cases(levels, device):
            got = cuda_vcycle.fused_smooth_cuda(op, b, **kw)
            want = cuda_vcycle.fused_smooth_twin(op, b, **kw)
            require(check_bf16(errors, "fused_smooth", got, want, main, f"{tag} level {lshape} {fname}"),
                    f"fused_smooth {tag} level {lshape} {fname}: not bitwise its twin")
            n_cases += 1
            if main and fname == "ec":
                # the V-cycle's two launches on this level, bf16 beside f32
                l32 = levels32[lvl]
                forms = smooth_forms(levels[lvl].tr, kw["x0"], kw["ec"])
                b32, x032, ec32 = b.float(), kw["x0"].float(), kw["ec"].float()
                for kind, kw16, kw32 in (("restrict", forms["restrict"], dict(forms["restrict"], tr=l32.tr)),
                                         ("ec", forms["ec"], dict(forms["ec"], x0=x032, ec=ec32, tr=l32.tr))):
                    t16 = time_ms(lambda: cuda_vcycle.fused_smooth_cuda(op, b, **kw16), 50, kernel=True)
                    t32 = time_ms(lambda: cuda_vcycle.fused_smooth_cuda(l32.op, b32, **kw32), 50, kernel=True)
                    rows.append((f"{kind} {lshape[0]}x{lshape[1]}", t16, t32, *smooth_bound(op, kw16)[:1],
                                 smooth_bound(l32.op, kw32)[0]))
                    if lvl == 0 and kind == "restrict":
                        times["fused_smooth_bf16"] = (
                            t16, time_ms(lambda: cuda_vcycle.fused_smooth_twin(op, b, **kw16), 10),
                            *smooth_bound(op, kw16))
        log(f"  {tag}: {len(levels)} levels {[tuple(lv.op.aC.shape) for lv in levels]}, the coarsest "
            f"{'inverted densely' if levels[-1].coarse_inv is not None else 'swept'}: fused_smooth's four forms "
            f"bitwise equal to the twin's at every smoothed level ({n_cases} cases)")
        if rows:
            log("  fused_smooth, one bf16 V(2,2) cycle's launches (device ms bf16 / f32 on the uncast level; "
                "bound bf16 / f32): " + "; ".join(f"{n} {a:.4f} / {c:.4f} ({a / c:.3f}x; {bb:.4f} / {bf32:.4f})"
                                                  for n, a, c, bb, bf32 in rows))
            log(f"  fused_smooth, the cycle's {len(rows)} launches summed: bf16 {sum(r[1] for r in rows):.4f} ms, "
                f"f32 {sum(r[2] for r in rows):.4f} ms ({sum(r[1] for r in rows) / sum(r[2] for r in rows):.3f}x)")
        # rb_sweep on the bf16 "mg" hierarchy
        mg_levels = bf16_mg_levels(shape, device)
        worst = 0.0
        for lshape, op, x0, b, reverse in bf16_sweep_cases(mg_levels, device):
            got = cuda_smoother.rb_sweep_cuda(op, x0, b, reverse)
            want = cuda_smoother.rb_sweep_twin(op, x0, b, reverse)
            worst = max(worst, float((got.float() - want.float()).abs().max()))
            what = f"{tag} mg level {lshape} reverse={reverse}"
            require(check_bf16(errors, "rb_sweep", got, want, main, what, scale=float(want.float().abs().max())),
                    f"rb_sweep {what}: not bitwise its twin")
        log(f"  {tag}: rb_sweep on the {len(mg_levels)} bf16 'mg' levels (both orders, zero and random x): "
            f"max|kernel - twin| {worst:.3e}, bitwise equal to the twin's")
        if main:
            op16, b16 = mg_levels[0], random_field(shape, 990, torch.float32, device).to(bf)
            op32 = random_operator(*shape, seed=13, dtype=torch.float32, device=device)
            x16 = random_field(shape, 991, torch.float32, device).to(bf)
            x32, b32 = x16.float(), b16.float()
            n = b16.numel()
            t16 = time_ms(lambda: cuda_smoother.rb_sweep_cuda(op16, x16, b16), 50, kernel=True)
            t32 = time_ms(lambda: cuda_smoother.rb_sweep_cuda(op32, x32, b32), 50, kernel=True)
            times["rb_sweep_bf16"] = (t16, time_ms(lambda: cuda_smoother.rb_sweep_twin(op16, x16, b16), 20),
                                      *bound(8 * 2 * n, 13 * n, bf))
            log(f"  rb_sweep 1026^2: bf16 {t16:.4f} ms, f32 {t32:.4f} ms ({t16 / t32:.3f}x); bound bf16 "
                f"{times['rb_sweep_bf16'][2]:.4f}, f32 {bound(8 * 4 * n, 13 * n, torch.float32)[0]:.4f} ms")
    # the limits of fused_smooth's tiling, in bf16
    limits = bf16_limit_cases(device)
    for name, what, op, b, kw in limits:
        got = cuda_vcycle.fused_smooth_cuda(op, b, **kw)
        want = cuda_vcycle.fused_smooth_twin(op, b, **kw)
        require(check_bf16(errors, "fused_smooth", got, want, False, f"bf16 {name} {what}"),
                f"fused_smooth bf16 {name} {what}: not bitwise its twin")
    log(f"  bf16: fused_smooth bitwise equal to the twin's on all {len(limits)} limit cases")
    return times


def checkout_lib(path: str, name: str) -> ctypes.CDLL:
    """The kernel library of another checkout ``path`` (e.g. the parent
    commit unpacked by git archive, or a variant of this one's csrc),
    built from its csrc into _build/<name> and bound like this commit's."""
    from fluidsolver_tpu_torch.poisson import _kernels

    return load_library(_kernels.build(csrc=Path(path) / "fluidsolver_tpu_torch" / "csrc",
                                       build_dir=_kernels.BUILD_DIR / name))


def in_turns(libs, fn) -> list:
    """``fn()`` timed through each library of ``libs`` ([(name, lib)], None
    = this commit's) in turns: forward, then backward (parent, this, this,
    parent with two); returns the mean ms of each."""
    order = list(range(len(libs))) + list(reversed(range(len(libs))))
    ms = [[] for _ in libs]
    for k in order:
        with kernel_library(libs[k][1]):
            ms[k].append(fn())
    return [sum(m) / len(m) for m in ms]


def bf16_parent_phase(device, parent, variants=(), probes=()) -> None:
    """With --parent: the parent's bf16 kernels torch.equal to this
    commit's on every input of phase 3e (rb_sweep at every level of both
    bf16 "mg" hierarchies, both orders, zero and random x; fused_smooth's
    four forms at every smoothed level of both bf16 BoxMG hierarchies and
    its 40 limit cases), and timed in turns (parent, this, this, parent):
    rb_sweep at every level of the 1026^2 "mg" hierarchy and one V-cycle's
    52 launches (4 a level, 16 on the coarsest), fused_smooth's 14 launches
    of one BoxMG cycle, each with its bound. ``variants``: further
    checkouts (tuning runs), held and timed the same way; ``probes``:
    checkouts timed only (cut-short kernels, whose outputs are not held)."""
    from fluidsolver_tpu_torch.poisson import cuda_smoother, cuda_vcycle

    others = [("parent", parent_lib(parent))] + [(f"variant {i}", checkout_lib(d, f"variant{i}"))
                                                 for i, d in enumerate(variants)]
    libs = [others[0], ("this", None)] + others[1:] + [(f"probe {i}", checkout_lib(d, f"probe{i}"))
                                                       for i, d in enumerate(probes)]

    def outputs(lib, fn):
        with kernel_library(lib):
            out = fn()
        return out if isinstance(out, tuple) else (out,)

    def same(fn, what):
        new = outputs(None, fn)
        for name, lib in others:
            require(all(torch.equal(o, w) for o, w in zip(outputs(lib, fn), new)),
                    f"the {name}'s bf16 {what} and this commit's differ")

    for shape in ((1026, 1026), (1023, 771)):
        cases = bf16_sweep_cases(bf16_mg_levels(shape, device), device)
        for lshape, op, x0, b, reverse in cases:
            same(lambda: cuda_smoother.rb_sweep_cuda(op, x0, b, reverse),
                 f"rb_sweep at {shape} level {lshape} reverse={reverse}")
        log(f"  bf16 {shape[0]}x{shape[1]}: the parent's rb_sweep torch.equal to this commit's on all "
            f"{len(cases)} cases (every 'mg' level, both orders, zero and random x)")
        cases = bf16_smooth_cases(bf16_levels(shape, device)[1], device)
        for _, lshape, fname, op, b, kw in cases:
            same(lambda: cuda_vcycle.fused_smooth_cuda(op, b, **kw), f"fused_smooth at {shape} {lshape} {fname}")
        log(f"  bf16 {shape[0]}x{shape[1]}: the parent's fused_smooth torch.equal to this commit's on all "
            f"{len(cases)} cases (four forms at every smoothed level)")
    limits = bf16_limit_cases(device)
    for name, what, op, b, kw in limits:
        same(lambda: cuda_vcycle.fused_smooth_cuda(op, b, **kw), f"fused_smooth {name} {what}")
    log(f"  bf16: the parent's fused_smooth torch.equal to this commit's on all {len(limits)} limit cases")

    head = ", ".join(name for name, _ in libs)
    # rb_sweep: every level of the 1026^2 "mg" hierarchy
    rows = []
    for lvl, op in enumerate(bf16_mg_levels((1026, 1026), device)):
        lshape = tuple(op.aC.shape)
        b = random_field(lshape, 990 + lvl, torch.float32, device).to(torch.bfloat16)
        x = random_field(lshape, 1990 + lvl, torch.float32, device).to(torch.bfloat16)
        ms = in_turns(libs, lambda: time_ms(lambda: cuda_smoother.rb_sweep_cuda(op, x, b), 50, kernel=True))
        n = b.numel()
        rows.append((lshape, ms, bound(8 * 2 * n, 13 * n, torch.bfloat16)[0]))
        log(f"  rb_sweep bf16 {lshape[0]}x{lshape[1]}, device ms in turns ({head}): "
            + ", ".join(f"{t:.4f}" for t in ms) + f"; this / parent = {ms[1] / ms[0]:.4f}; bound {rows[-1][2]:.4f}")
    weights = [4] * (len(rows) - 1) + [16]
    cyc = [sum(w * r[1][k] for w, r in zip(weights, rows)) for k in range(len(libs))]
    log(f"  rb_sweep bf16, one 'mg' V-cycle's {sum(weights)} launches (4 a level, 16 on the coarsest) in turns "
        f"({head}): " + ", ".join(f"{t:.4f}" for t in cyc) + f" ms; this / parent = {cyc[1] / cyc[0]:.4f}; "
        f"bound {sum(w * r[2] for w, r in zip(weights, rows)):.4f} ms")
    # fused_smooth: one BoxMG bf16 cycle's 14 launches
    levels = bf16_levels((1026, 1026), device)[1]
    total = [0.0] * len(libs)
    n_launch, bsum = 0, 0.0
    for _, lshape, fname, op, b, kw in bf16_smooth_cases(levels, device):
        if fname not in ("restrict", "ec"):
            continue
        ms = in_turns(libs, lambda: time_ms(lambda: cuda_vcycle.fused_smooth_cuda(op, b, **kw), 50, kernel=True))
        bt = smooth_bound(op, kw)[0]
        total = [a + t for a, t in zip(total, ms)]
        n_launch, bsum = n_launch + 1, bsum + bt
        log(f"  fused_smooth bf16 {fname} {lshape[0]}x{lshape[1]}, device ms in turns ({head}): "
            + ", ".join(f"{t:.4f}" for t in ms) + f"; this / parent = {ms[1] / ms[0]:.4f}; bound {bt:.4f}")
    log(f"  fused_smooth bf16, one BoxMG cycle's {n_launch} launches summed in turns ({head}): "
        + ", ".join(f"{t:.4f}" for t in total) + f" ms; this / parent = {total[1] / total[0]:.4f}; "
        f"bound {bsum:.4f} ms")


def sweep_parent_phase(device, parent) -> None:
    """With --parent: the parent's rb_sweep torch.equal to this commit's at
    every "mg" level of the 1026^2 box, f32 and f64, both orders, from a
    random x, and timed in turns at 1026^2 f32."""
    from fluidsolver_tpu_torch.poisson import cuda_smoother, mg

    plib = parent_lib(parent)
    for dtype in (torch.float32, torch.float64):
        levels = mg.build_hierarchy(random_operator(1026, 1026, seed=13, dtype=dtype, device=device))
        for lvl, op in enumerate(levels):
            lshape = tuple(op.aC.shape)
            b, x0 = random_field(lshape, 500 + lvl, dtype, device), random_field(lshape, 600 + lvl, dtype, device)
            for reverse in (False, True):
                with kernel_library(plib):
                    old = cuda_smoother.rb_sweep_cuda(op, x0, b, reverse)
                new = cuda_smoother.rb_sweep_cuda(op, x0, b, reverse)
                require(torch.equal(old, new), f"the parent's rb_sweep and this commit's differ at "
                        f"{str(dtype)[6:]} level {lshape} reverse={reverse}")
        log(f"  {str(dtype)[6:]}: the parent's rb_sweep torch.equal to this commit's at all {len(levels)} "
            f"'mg' levels, both orders")
    op = random_operator(1026, 1026, seed=13, dtype=torch.float32, device=device)
    b, x0 = random_field((1026, 1026), 700, torch.float32, device), random_field((1026, 1026), 701,
                                                                                  torch.float32, device)

    def timed(lib):
        with kernel_library(lib):
            return time_ms(lambda: cuda_smoother.rb_sweep_cuda(op, x0, b), 50, kernel=True)

    ms = [timed(lib) for lib in (plib, None, None, plib)]
    log(f"  rb_sweep 1026^2 f32, device ms in turns: parent {ms[0]:.4f}, this {ms[1]:.4f}, this {ms[2]:.4f}, "
        f"parent {ms[3]:.4f}; this / parent = {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}")


def smooth_parent_f64(device, parent) -> None:
    """With --parent: the parent's fused_smooth torch.equal to this
    commit's in f64 at the six launches of one bench V-cycle (f32 is held
    in smooth_report_phase)."""
    from fluidsolver_tpu_torch.poisson import cuda_vcycle

    plib = parent_lib(parent)
    launches = bench_smooth_launches(device, torch.float64)
    for name, op, b, kw in launches:
        with kernel_library(plib):
            old = cuda_vcycle.fused_smooth_cuda(op, b, **kw)
        new = cuda_vcycle.fused_smooth_cuda(op, b, **kw)
        old, new = (old if isinstance(old, tuple) else (old,)), (new if isinstance(new, tuple) else (new,))
        require(all(torch.equal(o, w) for o, w in zip(old, new)),
                f"the parent's fused_smooth and this commit's differ in f64 at {name}")
    log(f"  f64: the parent's fused_smooth torch.equal to this commit's at all {len(launches)} launches")


# ---- phase 4f ------------------------------------------------------------------
def bf16_cross_check_phase(device) -> None:
    """Phase 4f: GPU against CPU with pressure_precond_dtype="bfloat16", f64,
    3 steps: two_phase_channel(ny=16) on BoxMG and lid_driven(n=64) on "mg",
    both at tol 1e-11, held as phase 4e holds its cases
    (cross_check_case); then two_phase_channel(ny=16) on "mg" at the case's
    own tolerance (1e-6), where the bf16 "mg" cycle leaves the 1000:1
    channel's solves at the cap of 50 iterations or stalled (the CPU tests
    find the same in both packages). Unconverged, the two devices' runs
    differ by what the bf16 rounding of residuals that differ in their last
    f64 bits makes of 50 iterations: their final U, V, p and vf are held to
    1e-3 of their largest values and iter(p) to 2 a step."""
    from fluidsolver_tpu_torch import driver
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.poisson import _kernels

    for name, kw, solver, what in (("two_phase_channel", dict(ny=16), "boxmg", "fused_smooth_bf16"),
                                   ("lid_driven", dict(n=64), "mg", "rb_sweep_bf16")):
        case = get_case(name, **kw)
        case.cfg = dataclasses.replace(case.cfg, pressure_precond_dtype="bfloat16", pressure_solver=solver)
        _kernels.launches.clear()
        cross_check_case(device, case, 3, f"{name}({next(iter(kw.values()))}) {solver} bf16")
        require(_kernels.launches.get(what, 0) > 0 and _kernels.launches.get("tail_cycle", 0) == 0,
                f"{name} {solver} bf16 must launch {what} and no tail_cycle")
    case = get_case("two_phase_channel", ny=16)
    case.cfg = dataclasses.replace(case.cfg, pressure_precond_dtype="bfloat16", pressure_solver="mg")
    runs = []
    for dev in (device, torch.device("cpu")):
        sim = driver.Simulation(case, dtype=torch.float64, device=dev, save_output=False,
                                warn_nonconverged=False)
        rows = driver_rows(sim, max_steps=3)
        final = {k: getattr(sim.state.flow, k).cpu().numpy() for k in ("U", "V", "p")}
        final["vf"] = sim.state.vf.cpu().numpy()
        runs.append(([int(r["iter(p)"]) for r in rows[1:]], [r["res(p)"] for r in rows[1:]], final))
    (g_it, g_res, g), (c_it, c_res, c) = runs
    rels = {k: float(np.abs(g[k] - c[k]).max() / (np.abs(c[k]).max() or 1.0)) for k in g}
    log(f"  two_phase_channel(16) mg bf16 at tol 1e-6: iter(p) per step gpu {g_it}, cpu {c_it}; res(p) gpu "
        f"{['%.3e' % r for r in g_res]}, cpu {['%.3e' % r for r in c_res]}; final max|gpu - cpu| / max|cpu|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
    require(all(abs(a - b) <= 2 for a, b in zip(g_it, c_it)), "iter(p) differs by more than 2 a step")
    require(all(v <= 1e-3 for v in rels.values()), "mg bf16: a final field differs by more than 1e-3")


# ---- phase 12 ------------------------------------------------------------------
@contextlib.contextmanager
def recorded_solves(log_to: list):
    """Record every pressure solve's (tolerance, iterations, residual) while
    the block runs; the residuals stay on the device until read."""
    from fluidsolver_tpu_torch.solvers import incomp

    solve = incomp.pressure_solve

    def recording(*args, tol=None, **kw):
        out = solve(*args, tol=tol, **kw)
        log_to.append((tol, out[2], out[1]))
        return out

    incomp.pressure_solve = recording
    try:
        yield
    finally:
        incomp.pressure_solve = solve


def log_solve_exits(solves: list, cfg) -> tuple:
    """Log and return the solves that ended at the cap and those that ended
    above their tolerance (the stagnation window)."""
    capped = [(k, it, float(r)) for k, (tol, it, r) in enumerate(solves) if it >= cfg.pressure_max_iter]
    stalled = [(k, it, float(r)) for k, (tol, it, r) in enumerate(solves)
               if it < cfg.pressure_max_iter and float(r) > tol]
    nonfinite = [k for k, (_, _, r) in enumerate(solves) if not math.isfinite(float(r))]
    log(f"  solves (index, iterations, p_res) at the cap of {cfg.pressure_max_iter}: {capped}")
    log(f"  solves stopped above their tolerance (stagnation window): {stalled}")
    require(not nonfinite, f"solves with a non-finite residual: {nonfinite}")
    return capped, stalled


# phase 12's Σp_iter and bf16 launches a step as recorded before the bf16
# kernels' redesign (NVIDIA H100 80GB HBM3, 700 W; PERF.md): BoxMG 20
# steps, "mg" 10. Bitwise kernels leave both unchanged.
RECORDED_BF16 = {"boxmg": (1606, 1194.2), "mg": (1884, 10056.8)}


def bf16_bench_phase(device, g, cfg, vf0) -> dict:
    """Phase 12: the bench configuration with pressure_precond_dtype=
    "bfloat16", on BoxMG for 20 steps and on "mg" for 10: phase 6's report,
    the solves at the cap or on the stagnation window, the peak device
    memory, the exact launches (BoxMG: no tail_cycle or tail_setup, the
    levels above the coarsest built by fused_rap once a step, two bf16
    fused_smooth launches a level a V-cycle; "mg": the bf16 rb_sweep on
    every level), the host syncs 1 + p_iter + one a solve that ends before
    its cap, and a profiler split; the bf16 set-up (build, cast, dense
    inverse) queued behind a device sleep must return with the stream still
    busy (no host read). Returns the bf16 launches of both runs."""
    from fluidsolver_tpu_torch.poisson import boxmg, linsys, mg
    from fluidsolver_tpu_torch.solvers import incomp

    # the set-up makes no host read: queued behind a device sleep, it
    # returns while the stream is busy
    rho = torch.ones(g.shape_u, device=device)
    rho_v = torch.ones(g.shape_v, device=device)
    cfg16 = dataclasses.replace(cfg, pressure_precond_dtype="bfloat16")
    incomp.build_step_levels(rho, rho_v, g, cfg16)
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    levels = incomp.build_step_levels(rho, rho_v, g, cfg16)
    pending = not torch.cuda.current_stream(device).query()
    torch.cuda.synchronize()
    log(f"  BoxMG bf16 hierarchy: {len(levels)} levels {[lv.op.aC.shape[0] for lv in levels]}, coarsest inverse "
        f"{tuple(levels[-1].coarse_inv.shape)} {levels[-1].coarse_inv.dtype}; the set-up queued behind a device "
        f"sleep returned with the stream busy: {pending}")
    require(pending, "the bf16 hierarchy's set-up drained the stream (a host read)")
    n_smoothed = sum(lv.tr is not None for lv in levels)

    out = {}
    for solver, n_steps, kernels in (("boxmg", 20, tuple(k for k in BOXMG_STEP if not k.startswith("tail"))),
                                     ("mg", 10, MG_STEP)):
        log(f"  -- {solver} bf16, {n_steps} steps")
        cfg_s = dataclasses.replace(cfg16, pressure_solver=solver)
        solves, syncs = [], []
        torch.cuda.reset_peak_memory_stats(device)
        with recorded_solves(solves):
            step, state, launches, iters = drive_bench(device, g, cfg_s, vf0, n_steps, syncs_out=syncs)
        peak = torch.cuda.max_memory_allocated(device) / 2 ** 30
        log_solve_exits(solves, cfg_s)
        n_sub = cfg_s.num_subiter
        n_solves = n_steps * n_sub
        cycles = sum(iters) + n_solves
        require(len(solves) == n_solves, f"{len(solves)} pressure solves in {n_steps} steps")
        # dt > 0, one exit test an iteration, one more a solve that ends
        # before its cap: the dense coarse inverse adds none
        want_syncs = [1 + it + sum(s[1] < cfg_s.pressure_max_iter for s in solves[k * n_sub:(k + 1) * n_sub])
                      for k, it in enumerate(iters)]
        require(syncs == want_syncs, f"host syncs per step {syncs}, expected {want_syncs}")
        expected = {"elvira": n_steps, "curvature": n_steps, "overlap": n_steps, "step_ab": sum(iters),
                    "step_c": cycles, "step_init": n_solves, "fused_momentum": n_solves,
                    "fused_rhs": n_solves, "tail_cycle": 0, "tail_setup": 0}
        if solver == "boxmg":
            expected.update(fused_rap=n_smoothed * n_steps, fused_smooth=2 * n_smoothed * cycles,
                            fused_smooth_bf16=2 * n_smoothed * cycles, rb_sweep=0)
        else:
            meta = mg.build_hierarchy(linsys.StencilOp(*(torch.empty(g.shape_center, device="meta"),) * 5))
            sweeps = (len(meta) - 1) * (cfg.mg_pre + cfg.mg_post) + mg.COARSE_SWEEPS
            expected.update(rb_sweep=cycles * sweeps, rb_sweep_bf16=cycles * sweeps, fused_rap=0,
                            fused_smooth=0)
        log(f"  expected launches: {expected}; peak device memory {peak:.3f} GiB; Σp_iter {sum(iters)}")
        require(all(launches.get(k, 0) == v for k, v in expected.items()),
                f"{solver} bf16: the launch counts differ from the expected ones")
        name = "fused_smooth" if solver == "boxmg" else "rb_sweep"
        out[solver] = launches.get(name + "_bf16", 0)
        log(f"  {solver} bf16: Σp_iter {sum(iters)} in {n_steps} steps (recorded: {RECORDED_BF16[solver][0]}), "
            f"{out[solver] / n_steps:.1f} {name} bf16 launches a step (recorded: {RECORDED_BF16[solver][1]})")
        n_prof = 3 if solver == "boxmg" else 2
        by_name, busy = profile_bench(step, state, n_prof, kernels)
        t_k = by_name.get(name, (0.0, 0))[0]
        log(f"  {solver} bf16: {name} bf16 {t_k / 1e3 / n_prof:.4f} device ms a step, {t_k / max(busy, 1e-9):.3f} "
            f"of the device's busy time")
    return out


# ---- phase 13 ------------------------------------------------------------------
DFG_CASES = (("diffuse", "diffuse_ib_dfg"), ("sharp quadratic", "sharp_ib_dfg"), ("luchini", "luchini_ib_dfg"))


def dfg_phase(device) -> None:
    """Phase 13: the three DFG 2D-1 cases at ny=448 (2403 x 448) through the
    driver, f32, 10 steps each, held as phase 11 holds the IB channels (no
    NaN, |U| deep in the solid below 0.15, max|div| below 1e-3), with C_D
    (row-wise and surface), C_L and dp after the 10 steps; then
    immersed_interface(n=1024) with 1287 markers (a spacing of about one
    cell), 10 steps: set-up, ms/step, p_iter, no NaN, max|div| below 1e-3,
    the markers' largest displacement."""
    from fluidsolver_tpu_torch import driver
    from fluidsolver_tpu_torch.cases import dfg, get_case
    from fluidsolver_tpu_torch.ops import stencil

    um = dfg.u_mean(1, 0.0)
    for label, name in DFG_CASES:
        state, case = ib_case_phase(device, label, name, {}, 448)
        g = case.grid
        vals = [dfg.calc_c_d_surface(state.p, state.U, state.V, g, um), dfg.calc_c_d(state.p, state.U, g, um),
                dfg.calc_c_l_surface(state.p, state.U, state.V, g, um), dfg.calc_c_l(state.p, state.V, g, um),
                dfg.calc_p_diff(state.p, g)]
        cd_s, cd, cl_s, cl, dp = (float(v) for v in vals)
        log(f"    after {float(state.t):.4f} s from rest: C_D surface {cd_s:.6f}, row-wise {cd:.6f}; C_L surface "
            f"{cl_s:.6f}, column-wise {cl:.6f}; dp {dp:.6f}")
        require(all(math.isfinite(v) for v in (cd_s, cd, cl_s, cl, dp)), f"{label}: a non-finite coefficient")

    n_steps, n_markers = 10, 1287
    case = get_case("immersed_interface", n=1024, n_markers=n_markers)
    g = case.grid
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sim = driver.Simulation(case, dtype=torch.float32, device=device, save_output=False)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    events, iters = [event()], []

    def stash(state):
        events.append(event())
        iters.append(int(sim.observe()["iter(p)"]))

    sim.run(max_steps=n_steps, callback=stash)
    ms = step_ms(events)
    fl, m = sim.state.flow, sim.state.markers
    div = stencil.divergence(fl.U, fl.V, g.dx, g.dy)[1:-1, 1:-1]
    nan = not all(bool(torch.isfinite(t).all()) for t in (fl.U, fl.V, fl.p, m.x, m.y))
    disp = float(torch.max(torch.hypot(m.x - m.x0, m.y - m.y0)))
    log(f"  immersed_interface(n=1024, {n_markers} markers, spacing {2 * math.pi * 0.2 / n_markers / g.dx:.3f} "
        f"cells): set-up {setup:.3f} s; ms/step (CUDA events; median of steps 2-{sim.n_steps}) "
        f"{statistics.median(ms[1:]):.4f}, all steps {[round(v, 3) for v in ms]}; p_iter (cumulative) {iters}; "
        f"max|div| {float(div.abs().max()):.3e}; largest marker displacement {disp:.4e}; NaN {nan}; "
        f"t = {float(fl.t):.6f}")
    require(sim.n_steps == n_steps, f"immersed_interface: {sim.n_steps} steps")
    require(not nan, "immersed_interface: a non-finite field or marker")
    require(float(div.abs().max()) < 1e-3, "immersed_interface: max|div| >= 1e-3")


# ---- phase 4g ------------------------------------------------------------------
def extrapolation_fields(n: int) -> tuple:
    """tests/test_torch_extrapolate.py's protocol: a Taylor-Green velocity
    known inside a circle of radius 0.25 on an n^2 grid."""
    from fluidsolver_tpu_torch.core.grid import make_grid

    g = make_grid(0.0, 1.0, n, 0.0, 1.0, n)
    Xu, Yu = np.meshgrid(g.x, g.ym, indexing="ij")
    Xv, Yv = np.meshgrid(g.xm, g.y, indexing="ij")
    in_u = (Xu - 0.5) ** 2 + (Yu - 0.5) ** 2 <= 0.25 ** 2
    in_v = (Xv - 0.5) ** 2 + (Yv - 0.5) ** 2 <= 0.25 ** 2
    U0 = np.where(in_u, np.sin(2 * np.pi * Xu) * np.cos(2 * np.pi * Yu), 0.0)
    V0 = np.where(in_v, -np.cos(2 * np.pi * Xv) * np.sin(2 * np.pi * Yv), 0.0)
    return g, U0, V0, in_u, in_v


def close_on(what: str, got, want, tol: float) -> None:
    """max |got - want| <= tol max |want|, both moved to the CPU."""
    got, want = got.cpu(), want.cpu()
    err = float((got - want).abs().max()) / (float(want.abs().max()) or 1.0)
    log(f"    {what}: max|gpu - cpu| / max|cpu| {err:.3e} (bound {tol:g})")
    require(err <= tol, f"{what}: the card and the CPU differ by {err:.3e} > {tol:g}")


def extrapolate_mls_phase(device) -> None:
    """Phase 4g: ``ops/extrapolate.py`` and ``ib/mls.py`` on the card
    against the CPU, f64, at the CPU tests' sizes and tolerances
    (tests/test_torch_extrapolate.py: 1e-10 of the largest value, the CG
    iterations within 1 (sealed: 2), one counted host read per iteration;
    tests/test_torch_markers.py: 1e-12, the nearest-neighbour sample
    exact)."""
    from fluidsolver_tpu_torch.core import sync
    from fluidsolver_tpu_torch.core.grid import make_grid
    from fluidsolver_tpu_torch.ib import mls
    from fluidsolver_tpu_torch.ops import extrapolate

    cpu = torch.device("cpu")
    f64 = torch.float64

    def on(a, dev):
        return torch.as_tensor(np.asarray(a), device=dev)

    g, U0, V0, in_u, in_v = extrapolation_fields(24)
    const = {dev: extrapolate.constant_extrapolate(on(np.where(in_u, 3.5, 0.0), dev), on(in_u, dev), 64)
             for dev in (device, cpu)}
    close_on("constant_extrapolate 24^2, 64 sweeps", const[device], const[cpu], 1e-10)
    runs = {}
    for dev in (device, cpu):
        s0 = sync.count
        U, V, rel, iters = extrapolate.div_free_extrapolate(on(U0, dev), on(V0, dev), on(in_u, dev),
                                                            on(in_v, dev), g, tol=1e-11)
        runs[dev] = (U, V, float(rel), iters, sync.count - s0)
    (Ug, Vg, relg, itg, syncg), (Uc, Vc, relc, itc, _) = runs[device], runs[cpu]
    log(f"    div_free_extrapolate 24^2 tol 1e-11: iterations gpu {itg}, cpu {itc}; rel gpu {relg:.3e}; "
        f"host reads on the card {syncg}")
    require(abs(itg - itc) <= 1 and relg < 1e-10, "div_free_extrapolate: iterations or residual differ")
    require(syncg == itg + 1, "div_free_extrapolate: one host read per CG iteration and one for the exit test")
    close_on("div_free_extrapolate U", Ug, Uc, 1e-10)
    close_on("div_free_extrapolate V", Vg, Vc, 1e-10)

    g, U0, V0, in_u, in_v = extrapolation_fields(32)
    n_sweeps = max(U0.shape)
    sealed = {}
    for dev in (device, cpu):
        U_ext = extrapolate.constant_extrapolate(on(U0, dev), on(in_u, dev), n_sweeps)
        V_ext = extrapolate.constant_extrapolate(on(V0, dev), on(in_v, dev), n_sweeps)
        sealed[dev] = extrapolate.project_div_free(U_ext, V_ext, on(in_u, dev), on(in_v, dev), g, tol=1e-11,
                                                   max_iter=4000, seal_boundary=True)
    log(f"    project_div_free 32^2 sealed: iterations gpu {sealed[device][3]}, cpu {sealed[cpu][3]}")
    require(abs(sealed[device][3] - sealed[cpu][3]) <= 2, "project_div_free (sealed): iterations differ by > 2")
    close_on("project_div_free (sealed) U", sealed[device][0], sealed[cpu][0], 1e-10)
    close_on("project_div_free (sealed) V", sealed[device][1], sealed[cpu][1], 1e-10)

    rng = np.random.default_rng(0)
    px, py = rng.uniform(0, 1, 5), rng.uniform(0, 1, 5)
    bx, by = rng.uniform(0, 1, (7, 6)), rng.uniform(0, 1, (7, 6))
    ex, ey = rng.uniform(0.2, 0.8, 7), rng.uniform(0.2, 0.8, 7)
    r = np.linspace(-2.5, 2.5, 41)
    gt = make_grid(0.0, 2 * math.pi, 32, 0.0, 2 * math.pi, 32)
    Xu, Yu = np.meshgrid(gt.x, gt.ym, indexing="ij")
    Ut = np.sin(Xu) * np.cos(Yu)
    qx, qy = np.random.default_rng(2).uniform(0.3, 6.0, 50), np.random.default_rng(2).uniform(0.3, 6.0, 50)
    args = (gt.x[1], gt.dx, gt.ym[1], gt.dy)
    out = {}
    for dev in (device, cpu):
        out[dev] = [mls.mls_interpolate(on(px, dev), on(py, dev), on(2.0 * px - 3.0 * py + 0.5, dev),
                                        torch.tensor(0.4, dtype=f64, device=dev),
                                        torch.tensor(0.6, dtype=f64, device=dev), h=1.0),
                    mls.mls_shape_functions(on(bx, dev), on(by, dev), on(ex, dev), on(ey, dev), 0.6),
                    mls.cubic_spline_weight(on(r, dev), 1.0),
                    mls.eval_field_at_mls5(on(Ut, dev), *args, on(qx, dev), on(qy, dev)),
                    mls.eval_field_at_nn(on(Ut, dev), *args, on(qx, dev), on(qy, dev))]
    names = ("mls_interpolate", "mls_shape_functions", "cubic_spline_weight", "eval_field_at_mls5 (32^2 TGV)",
             "eval_field_at_nn (32^2 TGV)")
    for name, a, b in zip(names, out[device], out[cpu]):
        close_on(name, a, b, 0.0 if "nn" in name else 1e-12)
    require(abs(float(out[device][0]) - (2.0 * 0.4 - 3.0 * 0.6 + 0.5)) < 1e-10,
            "mls_interpolate does not reproduce a linear field on the card")


# ---- phase 4h ------------------------------------------------------------------
# the longest chain of roundings from the inputs to one coarse coefficient in
# galerkin_boxmg: three products (P, A, R) and the sums of prolong_box (up to
# 4 terms), apply_op9 (9) and restrict_box (9)
PROBE_ROUNDINGS = 3 + 3 + 8 + 8


def galerkin_f32_bound(op, tr, shape) -> list:
    """Entrywise bounds on |fused_rap - galerkin_boxmg| in f32. Both sides
    compute each coarse coefficient as a sum of the same triple products
    w1 a w2 (the closed form term by term, the probe through P, A and R), so
    each is off the exact value by at most gamma_n S, with S = sum |w1 a w2|
    (galerkin_closed of |A| and |P|, in f64) and n its longest chain of
    roundings (gamma_n = n u / (1 - n u), u = 2^-24): the closed form's two
    products and serial sum of T terms (n = T + 2), the probe's
    PROBE_ROUNDINGS. The bound is (gamma_closed + gamma_probe) S."""
    from fluidsolver_tpu_torch.poisson import boxmg

    u = 2.0 ** -24
    terms = boxmg._enumerate_rap_terms(len(boxmg.coefs(op)))
    gamma = lambda n: n * u / (1 - n * u)  # noqa: E731
    absolute = lambda s: dataclasses.replace(  # noqa: E731
        s, **{f.name: getattr(s, f.name).double().abs() for f in dataclasses.fields(s)})
    S = boxmg.galerkin_closed(absolute(op), absolute(tr), shape)
    return [(gamma(len(terms[boxmg._A_OFFSETS[n]]) + 2) + gamma(PROBE_ROUNDINGS)) * getattr(S, n)
            for n in boxmg.COEF_NAMES]


def galerkin_phase(device) -> None:
    """4h (2): kernel #4's coarse operator against galerkin_boxmg (comb
    probing) on the same operator and transfer, at every fused_rap level of
    the 1026^2 box (1026^2, 513^2, 257^2) and of the 1023 x 771 box: f64
    within 1e-12 of each plane's largest value, f32 within
    galerkin_f32_bound."""
    from fluidsolver_tpu_torch.poisson import boxmg, cuda_rap

    for dtype in (torch.float64, torch.float32):
        for shape in ((1026, 1026), (1023, 771)):
            for op in rap_levels(shape, dtype, device):
                lshape = tuple(op.aC.shape)
                tr, coarse = cuda_rap.fused_rap_cuda(op)
                probe = boxmg.galerkin_boxmg(op, tr, lshape)
                worst, worst_share = 0.0, 0.0
                bounds = galerkin_f32_bound(op, tr, lshape) if dtype == torch.float32 else None
                for k, name in enumerate(boxmg.COEF_NAMES):
                    got, want = getattr(coarse, name), getattr(probe, name)
                    diff = (got.double() - want.double()).abs()
                    scale = float(want.abs().max()) or 1.0
                    worst = max(worst, float(diff.max()) / scale)
                    if bounds is None:
                        require(float(diff.max()) <= 1e-12 * scale,
                                f"fused_rap f64 level {lshape} {name}: {float(diff.max()) / scale:.3e} of the "
                                "plane's largest value from galerkin_boxmg (> 1e-12)")
                    else:
                        share = float((diff / bounds[k].clamp_min(1e-300)).max())
                        worst_share = max(worst_share, share)
                        require(bool((diff <= bounds[k]).all()),
                                f"fused_rap f32 level {lshape} {name}: off galerkin_boxmg by up to {share:.3f} "
                                "of the rounding bound")
                extra = "" if bounds is None else f", {worst_share:.3e} of the f32 rounding bound at most"
                log(f"  fused_rap vs galerkin_boxmg, {str(dtype)[6:]} level {lshape}: max |diff| {worst:.3e} "
                    f"of a plane's largest value{extra}")


def hierarchy_shape(levels) -> list:
    return [(tuple(lv.op.aC.shape), "tail" if lv.tail is not None else
             "inverse" if lv.coarse_inv is not None else "fused_rap" if lv.tr is not None else "swept")
            for lv in levels]


def run_drop(dev, poison: bool, solves: list, rings: list):
    """The golden drop (phase 4b) in f64 on ``dev`` under FS_NAN_POISON=1 or
    0, each pressure solve recorded into ``solves`` and, for every
    calc_dmomdt / calc_drhodt call (the CPU path; the card runs kernel #8),
    whether its synthesized rings are all NaN (True), all zero (False) or
    neither (None) into ``rings``. Returns (initial state, final state)."""
    from fluidsolver_tpu_torch.ops import momentum as mom
    from fluidsolver_tpu_torch.solvers import twophase

    def ring_state(outs):
        states = set()
        for o in outs:
            ring = torch.ones_like(o, dtype=torch.bool)
            ring[1:-1, 1:-1] = False
            vals = o[ring]
            states.add(True if bool(torch.isnan(vals).all()) else False if bool((vals == 0).all()) else None)
        return states.pop() if len(states) == 1 else None

    def watched(fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            rings.append(ring_state(out))
            return out
        return call

    g, cfg, vf0, t_end = golden_drop()
    saved = os.environ.get("FS_NAN_POISON")
    dmom, drho = mom.calc_dmomdt, mom.calc_drhodt
    os.environ["FS_NAN_POISON"] = "1" if poison else "0"
    mom.calc_dmomdt, mom.calc_drhodt = watched(dmom), watched(drho)
    try:
        state0 = twophase.init_two_phase_state(g, cfg, vf0, torch.float64, dev)
        with recorded_solves(solves):
            state = twophase.run(state0, t_end, g, cfg)
    finally:
        mom.calc_dmomdt, mom.calc_drhodt = dmom, drho
        if saved is None:
            os.environ.pop("FS_NAN_POISON", None)
        else:
            os.environ["FS_NAN_POISON"] = saved
    return g, state0, state


def dense_inverse_phase(device, g_bench, cfg_bench, vf_bench) -> None:
    """Phase 4h, f64: (1) the hierarchies: lid_driven(64)'s and the golden
    drop's on the card end in the dense coarsest inverse with no tail, as
    the JAX package's CPU path does; the f32 1026^2 operator still starts
    its tail at level 3; lid_driven(64), 2 steps, and the drop take the same
    PCG iterations solve by solve on the card and the CPU; (2)
    galerkin_phase; (3) conserved_quantities of the drop at step 0 and
    after its 15 steps, the card against the CPU, within 1e-12 of the sum of
    the absolute terms (mass drift logged); (4) FS_NAN_POISON=1: the drop's
    U, V, p and vf torch.equal over the interior to the unpoisoned run on
    the card and on the CPU, and on the CPU every dmom and drho ring NaN
    (zero unpoisoned); (5) the core/fields.py helpers and
    ops.stencil.l1_norm on the bench's initial state, the card against the
    CPU (max, min exact, sums within 1e-12)."""
    from fluidsolver_tpu_torch.cases import get_case
    from fluidsolver_tpu_torch.core import fields
    from fluidsolver_tpu_torch.ops import momentum as mom
    from fluidsolver_tpu_torch.ops import stencil
    from fluidsolver_tpu_torch.poisson import boxmg, linsys
    from fluidsolver_tpu_torch.solvers import twophase

    cpu = torch.device("cpu")
    # (1) the hierarchies and their iterations
    case = get_case("lid_driven", n=64)
    case.cfg = dataclasses.replace(case.cfg, pressure_tol=1e-11)
    its = {}
    for where, dev in (("card", device), ("cpu", cpu)):
        step = case.make_step(torch.float64, dev)
        if where == "card":
            log(f"  lid_driven(64) f64 hierarchy on the card: {hierarchy_shape(step.levels)}")
            require(all(lv.tail is None for lv in step.levels) and step.levels[-1].coarse_inv is not None,
                    "lid_driven(64) f64: the hierarchy must end in the dense inverse, with no tail")
        solves = []
        state = case.make_state(torch.float64, dev)
        with recorded_solves(solves):
            for _ in range(2):
                state = step(state, case.t_end)
        its[where] = [it for _, it, _ in solves]
    log(f"  lid_driven(64) PCG iterations a solve: card {its['card']}, CPU {its['cpu']}")
    require(its["card"] == its["cpu"], "lid_driven(64): the card's PCG iterations differ from the CPU's")

    g, cfg, vf0, _ = golden_drop()
    state0 = twophase.init_two_phase_state(g, cfg, vf0, torch.float64, device)
    op = linsys.assemble_pressure_operator(state0.flow.rho_u, state0.flow.rho_v, g.dx, g.dy, cfg.pressure_pin)
    levels = boxmg.build_hierarchy(op)
    log(f"  golden drop f64 hierarchy on the card: {hierarchy_shape(levels)}")
    require(all(lv.tail is None for lv in levels) and levels[-1].coarse_inv is not None,
            "golden drop f64: the hierarchy must end in the dense inverse, with no tail")
    levels32 = boxmg.build_hierarchy(random_operator(1026, 1026, seed=13, dtype=torch.float32, device=device))
    log(f"  1026^2 f32 hierarchy on the card: {hierarchy_shape(levels32)}")
    require([lv.tail is not None for lv in levels32] == [False] * 3 + [True]
            and levels32[-1].tail.shapes[0] == (129, 129),
            "1026^2 f32: the tail must start at level 3 (129^2)")

    # (2) kernel #4 against the comb probe
    galerkin_phase(device)

    # (3), (4) the drop, plain and poisoned, on the card and on the CPU
    runs = {}
    for where, dev in (("card", device), ("cpu", cpu)):
        for poison in (False, True):
            solves, rings = [], []
            _, s0, s1 = run_drop(dev, poison, solves, rings)
            runs[(where, poison)] = (s0, s1, [it for _, it, _ in solves], rings)
    its_g, its_c = runs[("card", False)][2], runs[("cpu", False)][2]
    log(f"  golden drop PCG iterations a solve: card {its_g}, CPU {its_c}")
    require(its_g == its_c, "golden drop: the card's PCG iterations differ from the CPU's")
    for when, k in (("step 0", 0), ("step 15", 1)):
        got = [runs[("card", False)][k].flow, runs[("cpu", False)][k].flow]
        q = [mom.conserved_quantities(f.U, f.V, f.rho_u, f.rho_v, g.dx, g.dy) for f in got]
        f = got[1]
        scale = mom.conserved_quantities(f.U.abs(), f.V.abs(), f.rho_u, f.rho_v, g.dx, g.dy)
        for name, a, b, s in zip(("mass", "x-momentum", "y-momentum"), q[0], q[1], scale):
            a, b, s = float(a), float(b), float(s)
            log(f"  conserved_quantities {when} {name}: card {a!r}, CPU {b!r}, |diff| {abs(a - b):.3e} "
                f"(bound 1e-12 x {s:.6e})")
            require(abs(a - b) <= 1e-12 * s, f"conserved_quantities {when} {name}: card and CPU differ")
    for where in ("card", "cpu"):
        m0, m1 = (float(mom.conserved_quantities(f.U, f.V, f.rho_u, f.rho_v, g.dx, g.dy)[0])
                  for f in (runs[(where, False)][0].flow, runs[(where, False)][1].flow))
        log(f"  golden drop mass drift over 15 steps ({where}): {(m1 - m0) / m0:.3e}")
    for where in ("card", "cpu"):
        plain, poisoned = runs[(where, False)][1], runs[(where, True)][1]
        for name, a, b in (("U", plain.flow.U, poisoned.flow.U), ("V", plain.flow.V, poisoned.flow.V),
                           ("p", plain.flow.p, poisoned.flow.p), ("vf", plain.vf, poisoned.vf)):
            require(torch.equal(a[1:-1, 1:-1], b[1:-1, 1:-1]),
                    f"FS_NAN_POISON=1 changed {name} on the {where} (interior not torch.equal)")
        require(runs[(where, True)][2] == runs[(where, False)][2],
                f"FS_NAN_POISON=1 changed the iterations ({where})")
    rings_poisoned, rings_plain = runs[("cpu", True)][3], runs[("cpu", False)][3]
    log(f"  FS_NAN_POISON=1: U, V, p, vf torch.equal over the interior on the card and the CPU; CPU rings "
        f"checked in {len(rings_poisoned)} dmom/drho calls (NaN), {len(rings_plain)} unpoisoned (zero); "
        f"calls on the card {len(runs[('card', True)][3])}")
    require(rings_poisoned and all(r is True for r in rings_poisoned),
            "FS_NAN_POISON=1 on the CPU: a dmom or drho ring is not all NaN")
    require(rings_plain and all(r is False for r in rings_plain), "unpoisoned CPU run: a ring is not all zero")

    # (5) the fields helpers and l1_norm on the bench's initial state
    states = [twophase.init_two_phase_state(g_bench, cfg_bench, vf_bench, torch.float64, dev)
              for dev in (device, cpu)]
    for name in ("vf", "rho_u", "rho_v", "visc", "U"):
        a, b = (getattr(s, name) if name == "vf" else getattr(s.flow, name) for s in states)
        inner = fields.interior(a)
        require(inner._base is a and torch.equal(inner.cpu(), fields.interior(b)), f"interior({name})")
        flag = fields.has_nan_or_inf(a)
        require(flag.device == a.device and flag.shape == () and flag.dtype == torch.bool
                and not bool(flag) and not bool(fields.has_nan_or_inf(b)), f"has_nan_or_inf({name})")
        bad = a.clone()
        bad[5, 7] = float("nan")
        require(bool(fields.has_nan_or_inf(bad)), f"has_nan_or_inf({name} with a NaN)")
        for fn in (fields.abs_max, fields.fmax, fields.fmin):
            require(float(fn(a)) == float(fn(b)), f"{fn.__name__}({name}): card {float(fn(a))!r}, CPU {float(fn(b))!r}")
        for ghost in (False, True):
            x, y = float(stencil.l1_norm(a, g_bench.dx, g_bench.dy, ghost)), float(
                stencil.l1_norm(b, g_bench.dx, g_bench.dy, ghost))
            require(abs(x - y) <= 1e-12 * abs(y), f"l1_norm({name}, include_ghost={ghost}): card {x!r}, CPU {y!r}")
    log("  interior, has_nan_or_inf, abs_max, fmax, fmin (exact) and l1_norm (1e-12) on the bench state "
        "(vf, rho_u, rho_v, visc, U; f64): the card equals the CPU")


# ---- phase 14 ------------------------------------------------------------------
MESH_NDEV = 4


def slab_mesh(ndev: int):
    """``ndev`` slabs over the cards there are (all on cuda:0 with one)."""
    from fluidsolver_tpu_torch.parallel.mesh import SlabMesh

    count = torch.cuda.device_count()
    return SlabMesh([torch.device("cuda", i % count) for i in range(ndev)])


def mesh_smooth_inputs(device) -> list:
    """The V(2,2) phases of the distributed cycle on the three levels above
    the tail of the 1026^2 box (bench_smooth_launches' operators, b and x0):
    the pre-smoothing phase with its residual from zero and the
    post-smoothing phase from x0: [(name, level, op, b, kw)]."""
    out = []
    for i, (name, op, b, kw) in enumerate(bench_smooth_launches(device)):
        shape = name.split()[1]
        if name.startswith("restrict"):
            out.append((f"pre+residual {shape}", i // 2, op, b, dict(colors=(True, False) * 2, residual=True)))
        else:
            out.append((f"post {shape}", i // 2, op, b, dict(x0=kw["x0"], colors=(False, True) * 2)))
    return out


def mesh_smoother_phase(device, errors: Errors, op) -> tuple:
    """Phase 14a. (1) make_sharded_smoother torch.equal to the global
    fused_smooth (x and r) for ndev 2, 4 and 8 at the six phases of one
    bench V(2,2) cycle, each level padded with identity rows to the rows
    make_plan gives that level of the 1026^2 box (as dist_poisson pads); the
    kernel torch.equal to its twin on every extended slab; at ndev 4 each
    phase timed in turns with the global launch. (2) At ndev 4 on the
    hierarchy build_hierarchy_sharded makes of the bench's pressure operator
    ``op``: on every slab of every distributed level, both phases of the
    cycle (pre-smoothing with its residual, w = 6; post-smoothing from x0,
    w = 4) on the slab operators the V-cycle runs (DistLevel.extended), b
    and x0 of the plan's slab rows extended by w: the kernel torch.equal to
    its twin. Returns fused_smooth_local's (kernel ms, twin ms, bound ms,
    bound by), the mean over the slabs of level 0's pre-smoothing phase
    (the mesh path's largest slab)."""
    from fluidsolver_tpu_torch.parallel import cuda_shard, dist_poisson, mesh as mesh_mod
    from fluidsolver_tpu_torch.poisson import boxmg, cuda_vcycle

    def kernel_is_twin(op_ext, b_ext, x_ext, kw, what):
        for o, be, xe in zip(op_ext, b_ext, x_ext):
            kwe = dict(kw, x0=xe) if xe is not None else kw
            k = cuda_vcycle.fused_smooth_cuda(o, be, **kwe)
            t = cuda_vcycle.fused_smooth_twin(o, be, **kwe)
            k, t = (k, t) if isinstance(t, tuple) else ((k,), (t,))
            errors.compare("fused_smooth_local", k, t, torch.float32, 0.0, 0.0, True, what)
            require(all(torch.equal(a, c) for a, c in zip(k, t)),
                    f"{what}: the kernel is not bitwise its twin on an extended slab")

    cases = mesh_smooth_inputs(device)
    for ndev in (2, 4, 8):
        mesh = slab_mesh(ndev)
        plan = dist_poisson.make_plan(*cases[0][3].shape, ndev)
        if ndev == MESH_NDEV:
            log(f"  ndev {ndev}: slab devices {[str(d) for d in mesh.devices]}")
        for name, lvl, op_l, b, kw in cases:
            rows = plan.NX >> lvl
            op_p, b_p, x0_p = dist_poisson._pad_operator(op_l, b, kw.get("x0"), rows)
            kw_p = dict(kw, x0=x0_p) if "x0" in kw else kw
            smooth = cuda_shard.make_sharded_smoother(mesh, kw["colors"], residual=kw.get("residual", False))
            got = smooth(op_p, b_p, kw_p.get("x0"))
            want = cuda_vcycle.fused_smooth_cuda(op_p, b_p, **kw_p)
            got, want = (got, want) if isinstance(want, tuple) else ((got,), (want,))
            require(all(torch.equal(g, w) for g, w in zip(got, want)),
                    f"ndev {ndev} {name}: the slab smoother differs from the global fused_smooth")
            w = cuda_shard.halo_width(kw["colors"], kw.get("residual", False))
            slab = rows // ndev
            ops = dist_poisson._split_op(mesh, op_p, slab)
            op_ext = dist_poisson._extend_op(mesh, ops, w)
            bs = mesh_mod.scatter_rows(mesh, b_p, slab)
            xs = mesh_mod.scatter_rows(mesh, kw_p["x0"], slab) if "x0" in kw else None
            x_ext = mesh_mod.extend_x(mesh, xs, w) if xs is not None else [None] * ndev
            kernel_is_twin(op_ext, mesh_mod.extend_x(mesh, bs, w), x_ext, dict(kw), f"ndev {ndev} {name}")
            if ndev == MESH_NDEV:
                def global_call():
                    cuda_vcycle.fused_smooth_cuda(op_p, b_p, **kw_p)

                def slab_call():
                    cuda_shard.fused_smooth_local(mesh, ops, bs, xs, kw["colors"], kw.get("residual", False),
                                                  op_ext=op_ext)

                ms = [time_ms(fn, 50) for fn in (global_call, slab_call, slab_call, global_call)]
                gb = smooth_bound(op_p, kw_p)
                sb = sum(smooth_bound(o, dict(kw, x0=xe) if xe is not None else kw)[0]
                         for o, xe in zip(op_ext, x_ext))
                log(f"  ndev {ndev} {name} ({rows} rows, slabs of {slab} + 2 x {w}): torch.equal to the global "
                    f"kernel; device ms in turns: global {ms[0]:.4f}, slabs {ms[1]:.4f}, slabs {ms[2]:.4f}, "
                    f"global {ms[3]:.4f}; slabs / global {(ms[1] + ms[2]) / (ms[0] + ms[3]):.4f}; bound global "
                    f"{gb[0]:.4f} ({gb[1]}), the {ndev} extended slabs {sb:.4f}")
        log(f"  ndev {ndev}: NX {plan.NX}; the slab smoother torch.equal to the global fused_smooth at all "
            f"{len(cases)} phases, the kernel bitwise its twin on every extended slab")

    mesh = slab_mesh(MESH_NDEV)
    plan = dist_poisson.make_plan(*op.aC.shape, MESH_NDEV)
    levels, _ = dist_poisson.build_hierarchy_sharded(mesh, op)
    row = None
    for lvl, level in enumerate(levels):
        mx, cols = plan.mx[lvl], plan.ny[lvl]
        pad = mx * MESH_NDEV - plan.n_real[lvl]
        planes = [torch.nn.functional.pad(random_field((plan.n_real[lvl], cols), seed + lvl, torch.float32, device),
                                          (0, 0, 0, pad)) for seed in (400, 500)]
        bs, xs = (mesh_mod.scatter_rows(mesh, a, mx) for a in planes)
        for what, kw in (("pre+residual", dict(colors=(True, False) * 2, residual=True)),
                         ("post", dict(colors=(False, True) * 2))):
            w = cuda_shard.halo_width(kw["colors"], kw.get("residual", False))
            op_ext = level.extended(mesh, w)
            b_ext = mesh_mod.extend_x(mesh, bs, w)
            x_ext = mesh_mod.extend_x(mesh, xs, w) if what == "post" else [None] * MESH_NDEV
            shape = tuple(b_ext[0].shape)
            kernel_is_twin(op_ext, b_ext, x_ext, kw, f"mesh level {lvl} {what} {shape[0]}x{shape[1]}")
            log(f"  ndev {MESH_NDEV} level {lvl} {what}: {MESH_NDEV} extended slabs of {shape[0]} x {shape[1]} "
                f"({mx} + 2 x {w} rows, {len(boxmg.coefs(op_ext[0]))}-point): the kernel torch.equal to its twin")
            if lvl == 0 and what == "pre+residual":
                tk = statistics.mean(time_ms(lambda o=o, be=be: cuda_vcycle.fused_smooth_cuda(o, be, **kw),
                                             50, kernel=True) for o, be in zip(op_ext, b_ext))
                tt = statistics.mean(time_ms(lambda o=o, be=be: cuda_vcycle.fused_smooth_twin(o, be, **kw), 10)
                                     for o, be in zip(op_ext, b_ext))
                sb = [smooth_bound(o, kw) for o in op_ext]
                row = (tk, tt, statistics.mean(s[0] for s in sb), sb[0][1])
                log(f"  fused_smooth_local, one extended slab of level 0 {what} ({shape[0]} x {shape[1]}): kernel "
                    f"{tk:.4f} ms, twin {tt:.4f} ms, bound {row[2]:.4f} ms ({row[3]})")
    log(f"  ndev {MESH_NDEV}: the kernel bitwise its twin on every slab of all {plan.L_dist} distributed levels, "
        "both phases")
    return row


def bench_pressure_operator(device, g, cfg, vf0, dtype=torch.float32):
    """The pressure operator of the bench's initial densities."""
    from fluidsolver_tpu_torch.poisson import linsys
    from fluidsolver_tpu_torch.solvers import twophase

    state = twophase.init_two_phase_state(g, cfg, vf0, dtype, device)
    return linsys.assemble_pressure_operator(state.flow.rho_u, state.flow.rho_v, g.dx, g.dy, cfg.pressure_pin)


def mesh_levels_phase(device, op) -> None:
    """Phase 14b: the distributed levels, gathered and cropped to their real
    rows, torch.equal to the single-device fused_rap levels
    (build_hierarchy(tail=False)) at levels 0..L_dist, ndev 2 and 4."""
    from fluidsolver_tpu_torch.parallel import dist_poisson
    from fluidsolver_tpu_torch.poisson import boxmg

    single = boxmg.build_hierarchy(op, tail=False)
    for ndev in (2, MESH_NDEV):
        mesh = slab_mesh(ndev)
        plan = dist_poisson.make_plan(*op.aC.shape, ndev)
        levels, tail = dist_poisson.build_hierarchy_sharded(mesh, op)
        for lvl in range(plan.L_dist + 1):
            src = levels[lvl].op if lvl < plan.L_dist else [tail[0].op]
            for name in boxmg.COEF_NAMES[:len(boxmg.coefs(src[0]))]:
                got = torch.cat([getattr(o, name) for o in src])[:plan.n_real[lvl]]
                require(torch.equal(got, getattr(single[lvl].op, name)),
                        f"ndev {ndev}: distributed level {lvl} {name} differs from the single-device build")
        log(f"  ndev {ndev}: NX {plan.NX}, L_dist {plan.L_dist}, slab rows {plan.mx}; levels 0..{plan.L_dist} "
            f"torch.equal to the single-device build on their real rows ({plan.n_real}); the gathered tail "
            f"{len(tail)} level(s) from {tuple(tail[0].op.aC.shape)}")


def mesh_solve_phase(device, op) -> None:
    """Phase 14c: solve_pcg_sharded against cg.solve_pcg(precond="boxmg")
    on the bench's pressure operator (1026^2, f32, tol 1e-6, V(2,2)), ndev 2
    and 4: iterations within 1, both relative residuals at most tol, the
    solutions within 10 tol of the largest value; a prebuilt hierarchy
    (the same iterations, torch.equal x) and a warm start (x0 from a 1e-3
    solve); one counted host read per iteration and one for the exit."""
    from fluidsolver_tpu_torch.core import sync
    from fluidsolver_tpu_torch.parallel import dist_poisson
    from fluidsolver_tpu_torch.poisson import cg, linsys

    tol, kw = 1e-6, dict(max_iter=100, singular=True, n_pre=2, n_post=2)
    div = random_field(tuple(op.aC.shape), 77, torch.float32, device)
    n = op.aC.shape[0] - 2
    rhs = linsys.build_pressure_rhs(div, 1.0 / n, 1.0 / n, 1e-3, None)
    x0 = cg.solve_pcg(op, rhs, tol=1e-3, precond="boxmg", **kw)[0]

    def centred(x):
        return x - x.mean()

    for warm in (None, x0):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        xs, rs, its = cg.solve_pcg(op, rhs, tol=tol, precond="boxmg", x0=warm, **kw)
        torch.cuda.synchronize()
        t_single = time.perf_counter() - t0
        for ndev in (2, MESH_NDEV):
            mesh = slab_mesh(ndev)
            s0 = sync.count
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            xd, rd, itd = dist_poisson.solve_pcg_sharded(mesh, op, rhs, tol=tol, x0=warm, **kw)
            torch.cuda.synchronize()
            t_mesh, reads = time.perf_counter() - t0, sync.count - s0
            err = float((centred(xd) - centred(xs)).abs().max() / centred(xs).abs().max())
            what = f"ndev {ndev} {'warm' if warm is not None else 'cold'}"
            log(f"  {what}: iterations mesh {itd}, single {its}; rel mesh {float(rd):.3e}, single {float(rs):.3e}; "
                f"max|x_mesh - x_single| / max|x| {err:.3e}; host reads {reads}; wall s mesh {t_mesh:.3f}, "
                f"single {t_single:.3f}")
            require(abs(itd - its) <= 1, f"{what}: iterations {itd} against {its}")
            require(float(rd) <= tol and float(rs) <= tol, f"{what}: a residual above tol")
            require(err <= 10 * tol, f"{what}: solutions differ by {err:.3e}")
            require(reads == itd + (itd < kw["max_iter"]), f"{what}: {reads} host reads for {itd} iterations")
            if warm is None:
                levels = dist_poisson.build_hierarchy_sharded(mesh, op)
                xp, _, itp = dist_poisson.solve_pcg_sharded(mesh, op, rhs, tol=tol, levels=levels, **kw)
                require(itp == itd and torch.equal(xp, xd), f"{what}: the prebuilt hierarchy's solve differs")
                log(f"  {what}: the prebuilt hierarchy's solve torch.equal, {itp} iterations")


def mesh_cross_check(device, g, cfg, vf0, n_steps: int, what: str, make_state=None) -> None:
    """The mesh step on the card (4 slabs) against the mesh step on the CPU
    (SlabMesh(["cpu"] * 4)), f64, ``n_steps`` steps: U, V, p and vf within
    1e-9 of their scale, the same p_iter each step."""
    from fluidsolver_tpu_torch.parallel.mesh import SlabMesh
    from fluidsolver_tpu_torch.solvers import twophase

    cpu = torch.device("cpu")
    runs = {}
    for dev, mesh in ((device, slab_mesh(MESH_NDEV)), (cpu, SlabMesh([cpu] * MESH_NDEV))):
        state = (make_state(dev) if make_state is not None
                 else twophase.init_two_phase_state(g, cfg, vf0, torch.float64, dev))
        step = twophase.make_step(g, cfg, torch.float64, dev, mesh=mesh)
        iters = []
        for _ in range(n_steps):
            state = step(state, 1e9)
            iters.append(int(state.flow.p_iter))
        runs[dev] = (state, iters)
    (sg, ig), (sc, ic) = runs[device], runs[cpu]
    rels = {k: float((a.cpu() - b).abs().max() / (b.abs().max() or 1.0))
            for k, a, b in (("U", sg.flow.U, sc.flow.U), ("V", sg.flow.V, sc.flow.V), ("p", sg.flow.p, sc.flow.p),
                            ("vf", sg.vf, sc.vf))}
    log(f"  {what}: p_iter per step gpu {ig}, cpu {ic}; max|gpu - cpu| / max|cpu|: "
        + ", ".join(f"{k} {v:.3e}" for k, v in rels.items()))
    require(ig == ic, f"{what}: p_iter differs between the card and the CPU")
    require(all(v <= 1e-9 for v in rels.values()), f"{what}: a field differs by more than 1e-9")


def flagship_case(n: int = 48):
    """The JAX tests' flagship drop (__graft_entry__._flagship): the bench
    configuration at n^2 without the loose intermediate tolerance."""
    g, cfg = bench_case(n)
    return g, dataclasses.replace(cfg, pressure_tol_intermediate=None)


def mesh_cross_check_phase(device) -> None:
    """Phase 14d: GPU against CPU, f64, the mesh step (4 slabs) on
    two_phase_channel(ny=16) at tol 1e-11 (1e-9 intermediate), 3 steps, and
    on the flagship drop at n=48 (tol 1e-6), 3 steps."""
    from fluidsolver_tpu_torch.cases import get_case

    case = get_case("two_phase_channel", ny=16)
    cfg = dataclasses.replace(case.cfg, pressure_tol=1e-11, pressure_tol_intermediate=1e-9)
    mesh_cross_check(device, case.grid, cfg, None, 3, "two_phase_channel(16) tol 1e-11",
                     make_state=lambda dev: case.make_state(torch.float64, dev))
    g, cfg = flagship_case(48)
    mesh_cross_check(device, g, cfg, bench_vf0(g), 3, "flagship drop n=48 tol 1e-6")


def expected_mesh_launches(plan, tail_shape, ndev: int, n_steps: int, iters: list, n_subiter: int) -> dict:
    """The launches of the mesh bench step: one distributed hierarchy a step
    (fused_rap on every slab of every distributed level, then the gathered
    tail's build), one V-cycle per solve and PCG iteration (two slab phases
    a slab and distributed level, the tail), one overlap a shard, no fused
    PCG kernel."""
    solves = n_steps * n_subiter
    cycles = sum(iters) + solves
    n_above = above_tail_levels(tail_shape)
    local = 2 * plan.L_dist * ndev * cycles
    return {"elvira": n_steps, "curvature": n_steps, "overlap": ndev * n_steps,
            "fused_rap": (plan.L_dist * ndev + n_above) * n_steps, "tail_setup": n_steps, "tail_cycle": cycles,
            "fused_smooth_local": local, "fused_smooth": local + 2 * n_above * cycles,
            "step_ab": 0, "step_c": 0, "step_init": 0, "fused_momentum": solves, "rb_sweep": 0}


MESH_STEP = ("fused_smooth_local", "fused_smooth", "tail_cycle", "tail_setup", "fused_rap", "fused_momentum",
             "elvira", "curvature", "overlap")


def mesh_bench_phase(device, g, cfg, vf0) -> dict:
    """Phase 14e: the mesh step at full width, the bench configuration
    (1024^2, f32) on 4 slabs: step 1 against the single-device step (vf
    within 1e-5, each solve's iterations within 1); 10 steps with the
    launch counts set to 0 before the first and read after the last (every
    kernel of the path launched, the exact counts), no NaN, vf in
    [-1e-5, 1 + 1e-5], max|div| below 1e-3, host reads exactly 1 + p_iter
    + one a solve below the cap each step; ms/step beside 10 single-device
    steps; a 3-step profile (idle share). Returns the launches."""
    from fluidsolver_tpu_torch.ops import stencil
    from fluidsolver_tpu_torch.parallel import dist_poisson
    from fluidsolver_tpu_torch.solvers import twophase

    mesh = slab_mesh(MESH_NDEV)
    log(f"  slab devices {[str(d) for d in mesh.devices]}")
    state0 = twophase.init_two_phase_state(g, cfg, vf0, torch.float32, device)
    first = {}
    for label, m in (("single", None), ("mesh", mesh)):
        solves = []
        with recorded_solves(solves):
            out = twophase.make_step(g, cfg, torch.float32, device, mesh=m)(state0, 1e9)
        first[label] = (out, [it for _, it, _ in solves])
    dvf = float((first["mesh"][0].vf - first["single"][0].vf).abs().max())
    log(f"  step 1: iterations per solve mesh {first['mesh'][1]}, single {first['single'][1]}; "
        f"max|vf_mesh - vf_single| {dvf:.3e}")
    require(dvf <= 1e-5, f"step 1: vf differs from the single-device step by {dvf:.3e}")
    require(len(first["mesh"][1]) == len(first["single"][1]) == cfg.num_subiter
            and all(abs(a - b) <= 1 for a, b in zip(first["mesh"][1], first["single"][1])),
            "step 1: a solve's iterations differ from the single-device step's by more than 1")

    n_steps = 10
    log("  the single-device step, 10 steps:")
    drive_bench(device, g, cfg, vf0, n_steps)
    log(f"  the mesh step ({MESH_NDEV} slabs), 10 steps:")
    syncs, solves = [], []
    with recorded_solves(solves):
        step, state, launches, iters = drive_bench(device, g, cfg, vf0, n_steps, syncs_out=syncs, mesh=mesh)
    per_step = [[it for _, it, _ in solves[k * cfg.num_subiter:(k + 1) * cfg.num_subiter]] for k in range(n_steps)]
    rule = [1 + sum(its) + sum(it < cfg.pressure_max_iter for it in its) for its in per_step]
    log(f"  host reads per step {syncs}; 1 + p_iter + solves below the cap {rule}")
    require(syncs == rule, "the mesh step's host reads differ from the single-device rule")
    div = stencil.divergence(state.flow.U, state.flow.V, g.dx, g.dy)[1:-1, 1:-1]
    require(float(div.abs().max()) < 1e-3, "mesh step: max|div| >= 1e-3")
    plan = dist_poisson.make_plan(g.nx + 2, g.ny + 2, MESH_NDEV)
    tail_shape = (plan.n_real[plan.L_dist], plan.ny[plan.L_dist])
    expected = expected_mesh_launches(plan, tail_shape, MESH_NDEV, n_steps, iters, cfg.num_subiter)
    per = {k: launches.get(k, 0) / n_steps for k in MESH_STEP}
    log(f"  launches per step: {per}; expected in 10 steps {expected}")
    for name in MESH_STEP:
        require(launches.get(name, 0) > 0, f"kernel {name} was not launched on the mesh path")
    require(all(launches.get(k, 0) == v for k, v in expected.items()), "the mesh step's launch counts differ")

    holder = [state]

    def one():
        holder[0] = step(holder[0], 1e9)

    by_name, busy, wall_us, ranges = profile_steps(one, 3)
    log(f"  3 profiled mesh steps: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, idle share "
        f"{1 - busy / wall_us:.3f}; pressure solves {ranges.get(twophase.PRESSURE_RANGE, 0.0) / 1e3:.4f} ms, "
        f"VOF stage {ranges.get(twophase.VOF_RANGE, 0.0) / 1e3:.4f} ms")
    for name, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:10]:
        log(f"    {t / 1e3:9.4f}  {c:5d}  {name}")
    return launches


def mesh_overflow_phase(device, g, vf0) -> None:
    """Phase 14f: a lane budget below a shard's active set gives an
    infinite volume error on the card."""
    from fluidsolver_tpu_torch.parallel import dist_vof
    from fluidsolver_tpu_torch.vof import plic

    vf = torch.as_tensor(vf0, dtype=torch.float32, device=device)
    U, V, Ui, Vi = swirl_velocity(g, torch.float32, device)
    rec = plic.elvira(vf, g.dx, g.dy)
    _, err = dist_vof.advect_sharded(slab_mesh(MESH_NDEV), vf, rec, U, V, Ui, Vi, g, 0.4 * g.dx, m_total=16)
    log(f"  a budget of 16 lanes (4 a shard): volume error {float(err)}")
    require(math.isinf(float(err)), "a shard's lane overflow did not give an infinite volume error")


def mesh_phase(device, errors: Errors, g, cfg, vf0) -> tuple:
    """Phase 14; returns (fused_smooth_local's times, the mesh step's
    launches)."""
    op = bench_pressure_operator(device, g, cfg, vf0)
    log("phase 14a: the slab smoother against the global fused_smooth, ndev 2, 4, 8, and the kernel against its "
        "twin on the mesh path's slabs, f32")
    row = mesh_smoother_phase(device, errors, op)
    log("phase 14b: the distributed levels against the single-device build, 1026^2 f32")
    mesh_levels_phase(device, op)
    log("phase 14c: solve_pcg_sharded against cg.solve_pcg on the bench's operator, 1026^2 f32, tol 1e-6")
    mesh_solve_phase(device, op)
    log("phase 14d: the mesh step, GPU against CPU, f64")
    mesh_cross_check_phase(device)
    log("phase 14e: the mesh step at full width, the bench configuration on 4 slabs, 1024^2 f32")
    launches = mesh_bench_phase(device, g, cfg, vf0)
    log("phase 14f: a shard's lane overflow")
    mesh_overflow_phase(device, g, vf0)
    return row, launches


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Smoke test of the PyTorch/CUDA port on one H100.")
    ap.add_argument("--parent", default=None,
                    help="a checkout of another commit: also hold its fused_rap, tail_setup, fused_smooth, "
                         "elvira, curvature, overlap, step_ab, step_c, step_init and rb_sweep (and the bf16 forms "
                         "of fused_smooth and rb_sweep) bitwise to this one's and time them and its tail_cycle "
                         "against this one's (phases 3-3e)")
    parent = ap.parse_args(argv).parent
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    t_start = time.perf_counter()
    phase = "1 device"
    errors = Errors()
    try:
        # phase 1
        name = torch.cuda.get_device_name(0)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60)
        log(f"phase 1: torch device {name!r}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
            f"CUDA {torch.version.cuda}")
        log(smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "nvidia-smi: no output")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        phase = "2 build"
        from fluidsolver_tpu_torch.poisson import _kernels

        t0 = time.perf_counter()
        _kernels.build(verbose=True)
        _kernels.lib()
        log(f"phase 2: kernels built and loaded in {time.perf_counter() - t0:.1f} s ({_kernels.library_path().name})")

        g_bench, cfg_bench = bench_case()
        t0 = time.perf_counter()
        vf_bench = bench_vf0(g_bench)
        log(f"bench drop vf0 (1026^2, 16x16 Gauss points per cell) in {time.perf_counter() - t0:.1f} s")

        phase = "3 kernels vs twins"
        log("phase 3: BoxMG kernels against their twins on the card")
        tail_start = {}
        times = kernel_phase(device, errors, tail_start)
        rap_limits_phase(device, errors)
        rap_report_phase(device, parent)
        tail_domain_phase(device, errors)
        tail_report_phase(device, tail_start, parent)
        smooth_limits_phase(device, errors)
        smooth_report_phase(device, parent)
        phase = "3b VOF kernels vs twins"
        log("phase 3b: VOF kernels against their twins on the card")
        times.update(vof_kernel_phase(device, errors, vf_bench, g_bench))
        elvira_limits_phase(device, errors)
        elvira_report_phase(device, vf_bench, g_bench, parent)
        curvature_limits_phase(device, errors)
        curvature_report_phase(device, vf_bench, g_bench, parent)
        overlap_limits_phase(device, errors, vf_bench, g_bench)
        overlap_report_phase(device, vf_bench, g_bench, cfg_bench, parent)
        phase = "3c fused kernels vs twins"
        log("phase 3c: the fused PCG iteration, momentum and RHS kernels against their twins on the card")
        times.update(fused_kernel_phase(device, errors))
        times.update(rhs_kernel_phase(device, errors))
        cg_limits_phase(device, errors)
        if parent is not None:
            cg_turns(device, parent_lib(parent), _kernels.lib())
        phase = "3d rb_sweep vs twin"
        log("phase 3d: the red-black sweep kernel against its twin on the card")
        times.update(sweep_phase(device, errors))
        if parent is not None:
            sweep_parent_phase(device, parent)
            smooth_parent_f64(device, parent)
        phase = "3e bf16 kernels vs twins"
        log("phase 3e: the bf16 forms of fused_smooth and rb_sweep against their twins on the card")
        times.update(bf16_phase(device, errors))
        if parent is not None:
            bf16_parent_phase(device, parent)
        for k, (tk, tt, tb, by) in times.items():
            log(f"  {k}: kernel {tk:.4f} ms, twin {tt:.4f} ms, bound {tb:.4f} ms ({by}) "
                "(f32, main-path shape)")

        phase = "4 cross-check"
        log("phase 4: lid_driven(256) f64 tol 1e-11, 3 steps, GPU kernels vs CPU twins")
        cross_check_phase(device)
        phase = "4b two-phase cross-check"
        log("phase 4b: golden two-phase drop 64^2 f64 tol 1e-10, 15 steps, GPU vs CPU vs golden")
        two_phase_cross_check_phase(device)
        phase = "4c pressure solvers cross-check"
        log("phase 4c: lid_driven(64) f64 tol 1e-11, 2 steps, every pressure method and solver, GPU vs CPU")
        solver_cross_check_phase(device)
        phase = "4d driver cross-check"
        log("phase 4d: the driver, two_phase_channel(16) f64 tol 1e-11 3 steps and vof_tgv(64) f64 10 "
            "kinematic steps, GPU vs CPU")
        driver_cross_check_phase(device)
        phase = "4e options cross-check"
        log("phase 4e: the two-phase options, expanding_bubble(32) and the IB cases at ny=16, f64 tol 1e-11, "
            "3 steps each, GPU vs CPU")
        options_cross_check_phase(device)
        phase = "4f bf16 cross-check"
        log('phase 4f: pressure_precond_dtype="bfloat16", f64, 3 steps, GPU vs CPU: two_phase_channel(16) on '
            'BoxMG and "mg", lid_driven(64) on "mg"')
        bf16_cross_check_phase(device)
        phase = "4g extrapolation and MLS cross-check"
        log("phase 4g: ops/extrapolate.py and ib/mls.py, f64, GPU vs CPU at the CPU tests' sizes")
        extrapolate_mls_phase(device)
        phase = "4h dense coarsest inverse and diagnostics"
        log("phase 4h: the f64 hierarchies' dense coarsest inverse, fused_rap against galerkin_boxmg, "
            "conserved_quantities, FS_NAN_POISON=1 and the fields helpers, GPU vs CPU")
        dense_inverse_phase(device, g_bench, cfg_bench, vf_bench)

        phase = "5 full size"
        log("phase 5: lid_driven(1024) f32, 20 steps on the card")
        full_size_phase(device)
        phase = "6 bench"
        log("phase 6: two-phase bench configuration 1024^2 f32, 20 steps on the card")
        launches = bench_phase(device, g_bench, cfg_bench, vf_bench)
        phase = "7 mg bench"
        log('phase 7: the bench configuration on PCG + "mg", 1024^2 f32, 10 steps on the card')
        launches["rb_sweep"] = mg_bench_phase(
            device, g_bench, dataclasses.replace(cfg_bench, pressure_solver="mg"), vf_bench)["rb_sweep"]
        phase = "8a driver, two_phase_channel(448)"
        log("phase 8a: the driver on two_phase_channel(ny=448), 2240 x 448 f32, 10 steps, VTK, "
            "in turns with the bare steps")
        driver_channel_phase(device)
        phase = "8b CLI"
        log("phase 8b: driver.main on stationary_drop(n=256) f32 with --profile")
        driver_cli_phase(device)
        phase = "8c driver, vof_tgv(1024)"
        log("phase 8c: the driver on vof_tgv(n=1024) f64, 20 kinematic steps")
        driver_kinematic_phase(device)
        phase = "9 bench options"
        log("phase 9: the two-phase options on the bench configuration, 1024^2 f32, BoxMG, refresh step")
        quad_launches = bench_options_phase(device, g_bench, cfg_bench, vf_bench)
        phase = "10 expanding bubble"
        log("phase 10: expanding_bubble(n=1024, m_dot=1) f32, 10 steps")
        expanding_bubble_phase(device)
        phase = "11 immersed boundaries"
        log("phase 11: the IB cases at the bench's cell count through the driver, f32, 10 steps each")
        ib_phase(device)
        phase = "12 bench bf16"
        log('phase 12: the bench configuration with pressure_precond_dtype="bfloat16", 1024^2 f32, BoxMG 20 '
            'steps and "mg" 10 steps')
        bf16_launches = bf16_bench_phase(device, g_bench, cfg_bench, vf_bench)
        phase = "13 DFG and immersed interface"
        log("phase 13: the DFG cases at 2403 x 448 and immersed_interface(1024) through the driver, f32, "
            "10 steps each")
        dfg_phase(device)
        phase = "14 the x-slab mesh"
        log(f"phase 14: the x-slab mesh (kernel #1 on slabs, the distributed BoxMG-PCG, the sharded advection, "
            f"the mesh step) on {torch.cuda.device_count()} card(s)")
        local_times, mesh_launches = mesh_phase(device, errors, g_bench, cfg_bench, vf_bench)
    except Exception as exc:  # report the phase, then fail
        print(f"chip_smoke: phase {phase} FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        import traceback

        traceback.print_exc()
        return 1
    kernels = [{
        "name": k, "route": "cuda", "source": REPLACES[k][0], "replaces": REPLACES[k][1],
        "launches": launches[k], "max_abs_err": errors.max_abs[k],
        "ms": times[k][0], "plain_ms": times[k][1], "bound_ms": times[k][2], "bound_by": times[k][3],
        "library_ms": None,
    } for k in REPLACES]
    # overlap's quad variant: its launches under vof_no_correction (phase 9)
    # and its time on the bench drop's quads (phase 3b)
    quad = times["overlap_n0_4"]
    next(k for k in kernels if k["name"] == "overlap")["n0_4"] = {
        "launches": quad_launches, "ms": quad[0], "plain_ms": quad[1], "bound_ms": quad[2], "bound_by": quad[3]}
    # the bf16 forms of #1 and #9: their launches on phase 12's BoxMG and
    # "mg" runs, their times at 1026^2 (phase 3e)
    for k, run in (("fused_smooth", "boxmg"), ("rb_sweep", "mg")):
        t = times[k + "_bf16"]
        next(e for e in kernels if e["name"] == k)["bf16"] = {
            "launches": bf16_launches[run], "max_abs_err": errors.max_abs[k + "_bf16"], "ms": t[0],
            "plain_ms": t[1], "bound_ms": t[2], "bound_by": t[3], "library_ms": None}
    # kernel #1 on the mesh step's slabs (parallel/cuda_shard.py): its
    # launches on phase 14e's run, its time on one slab of the 1026^2
    # pre-smoothing phase (phase 14a)
    kernels.append({
        "name": "fused_smooth_local", "route": "cuda", "source": REPLACES["fused_smooth"][0],
        "wrapper": "fluidsolver_tpu_torch/parallel/cuda_shard.py",
        "replaces": "fluidsolver_tpu/parallel/pallas_shard.py:56", "launches": mesh_launches["fused_smooth_local"],
        "max_abs_err": errors.max_abs["fused_smooth_local"], "ms": local_times[0], "plain_ms": local_times[1],
        "bound_ms": local_times[2], "bound_by": local_times[3], "library_ms": None,
        "mesh_step_launches": {k: mesh_launches.get(k, 0) for k in MESH_STEP}})
    log(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
