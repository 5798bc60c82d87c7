"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero before the
result line):
  1. the device: torch's name for it and nvidia-smi's name and power limit;
  2. the kernel build (nvcc, sm_90a), with its time;
  3. each of the four BoxMG kernels against its plain PyTorch twin on the
     card, in f64 at the CPU tests' tolerances and in f32 at a relative
     (to max |twin|) tolerance of 1e-5, at the level shapes of
     lid_driven(n=1024) and of an odd 1023 x 771 grid; kernel and twin
     times by CUDA events at the main path's shapes;
  4. lid_driven(n=256), f64, pressure_tol=1e-11, 3 steps: the GPU
     (kernels) against the CPU (twins);
  5. lid_driven(n=1024), f32, 20 steps through the case's step: ms/step,
     PCG iterations and residual per step, max |div|, host syncs per step,
     the kernel launch counts of that run, and the kernels seen by
     torch.profiler over make_step plus one step.
The second-to-last line is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

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
}
# the names the kernels carry in a profiler trace
TRACE_NAMES = {"fused_rap": "fused_rap_kernel", "fused_smooth": "fused_smooth_kernel",
               "tail_setup": "tail_setup_kernel", "tail_cycle": "tail_cycle_kernel"}
F32_RTOL = 1e-5


class PhaseFailure(Exception):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailure(msg)


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


# ---- comparisons -------------------------------------------------------------
class Errors:
    """Max abs error per kernel over the f32 comparisons at the main path's
    shapes (reported in the kernels line)."""

    def __init__(self):
        self.max_abs = {}

    def compare(self, name, got, want, dtype, rtol, atol, main_path, what):
        got, want = list(got), list(want)
        worst = 0.0
        for g, w in zip(got, want):
            diff = (g - w).abs()
            if dtype == torch.float64:
                ok = bool((diff <= atol + rtol * w.abs()).all())
                bound = "atol %g rtol %g" % (atol, rtol)
            else:
                scale = float(w.abs().max())
                ok = float(diff.max()) <= F32_RTOL * max(scale, 1e-30)
                bound = "%g x max|twin| = %g" % (F32_RTOL, F32_RTOL * scale)
            worst = max(worst, float(diff.max()))
            require(ok, f"{name} {what}: max|kernel - twin| = {float(diff.max()):.3e} exceeds {bound}")
        if main_path and dtype == torch.float32:
            self.max_abs[name] = max(self.max_abs.get(name, 0.0), worst)
        return worst


def time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# ---- phase 3 ---------------------------------------------------------------
def kernel_phase(device, errors: Errors) -> dict:
    from fluidsolver_tpu_torch.poisson import boxmg, cuda_rap, cuda_tail, cuda_vcycle

    times = {}
    for dtype, shape, main in ((torch.float64, (1026, 1026), True), (torch.float32, (1026, 1026), True),
                               (torch.float64, (1023, 771), False), (torch.float32, (1023, 771), False)):
        tag = f"{str(dtype)[6:]} {shape[0]}x{shape[1]}"
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
                if main and dtype == torch.float32:
                    times["tail_setup"] = (time_ms(lambda: cuda_tail.build_tail_pack_cuda(op, n_rem), 20),
                                           time_ms(lambda: cuda_tail.build_tail_pack_twin(op, n_rem), 3))
                    times["tail_cycle"] = (time_ms(lambda: cuda_tail.tail_cycle_cuda(pt, b, 2, 2), 50),
                                           time_ms(lambda: cuda_tail.tail_cycle_twin(pt, b, 2, 2), 3))
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
                got = cuda_vcycle.fused_smooth_cuda(op, b, **kw)
                want = cuda_vcycle.fused_smooth_twin(op, b, **kw)
                got = got if isinstance(got, tuple) else (got,)
                want = want if isinstance(want, tuple) else (want,)
                rtol = 1e-11 if vname == "restrict" else 0.0
                atol = 1e-11 if vname == "restrict" else 1e-12
                errors.compare("fused_smooth", got, want, dtype, rtol, atol, main,
                               f"{tag} level {lshape} variant {vname}")
            if main and dtype == torch.float32 and level == 0:
                kw = variants["restrict"]
                times["fused_rap"] = (time_ms(lambda: cuda_rap.fused_rap_cuda(op), 20),
                                      time_ms(lambda: cuda_rap.fused_rap_twin(op), 3))
                times["fused_smooth"] = (time_ms(lambda: cuda_vcycle.fused_smooth_cuda(op, b, **kw), 50),
                                         time_ms(lambda: cuda_vcycle.fused_smooth_twin(op, b, **kw), 10))
            log(f"  {tag}: level {lshape}: fused_rap and fused_smooth (4 variants) agree")
            op = ct
            level += 1
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


# ---- phase 5 ---------------------------------------------------------------
def full_size_phase(device) -> dict:
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
    for name in REPLACES:
        require(launches.get(name, 0) > 0, f"kernel {name} was not launched on the main path")
    # one V-cycle per PCG iteration plus one per solve; each runs one tail
    # cycle and two smoothing phases per level above the tail
    n_above = len(step.levels) - 1
    cycles = sum(iters) + 20 * case.cfg.num_subiter
    require(launches["tail_cycle"] == cycles and launches["fused_smooth"] == 2 * n_above * cycles,
            f"expected {cycles} tail cycles and {2 * n_above * cycles} smoothing phases")

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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step = case.make_step(dtype, device)
        state = step(state, case.t_end)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    counts = {k: sum(TRACE_NAMES[k] in n for n in names) for k in TRACE_NAMES}
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            state = step(state, case.t_end)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            n = next((k for k, v in TRACE_NAMES.items() if v in e.name), e.name[:70])
            t, c = by_name.get(n, (0.0, 0))
            by_name[n] = (t + e.time_range.elapsed_us(), c + 1)
    busy = sum(t for t, _ in by_name.values())
    log(f"  3 profiled steps: wall {wall_us / 1e3:.3f} ms, device busy {busy / 1e3:.3f} ms, "
        f"idle share {1 - busy / wall_us:.3f}; device time by kernel (ms, launches):")
    for n, (t, c) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        log(f"    {t / 1e3:9.4f}  {c:5d}  {n}")
    return {"launches": launches}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    phase = "1 device"
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

        phase = "3 kernels vs twins"
        log("phase 3: kernels against their twins on the card")
        errors = Errors()
        times = kernel_phase(device, errors)
        for k, (tk, tt) in times.items():
            log(f"  {k}: kernel {tk:.4f} ms, twin {tt:.4f} ms (f32, main-path shape)")

        phase = "4 cross-check"
        log("phase 4: lid_driven(256) f64 tol 1e-11, 3 steps, GPU kernels vs CPU twins")
        cross_check_phase(device)

        phase = "5 full size"
        log("phase 5: lid_driven(1024) f32, 20 steps on the card")
        full = full_size_phase(device)
    except Exception as exc:  # report the phase, then fail
        print(f"chip_smoke: phase {phase} FAILED: {type(exc).__name__}: {exc}", file=sys.stderr)
        import traceback

        traceback.print_exc()
        return 1

    kernels = [{
        "name": k, "route": "cuda", "source": REPLACES[k][0], "replaces": REPLACES[k][1],
        "launches": full["launches"].get(k, 0), "max_abs_err": errors.max_abs[k],
        "ms": times[k][0], "plain_ms": times[k][1],
    } for k in REPLACES]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
