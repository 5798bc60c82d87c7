"""High-level simulation driver: port of ``fluidsolver_tpu.driver``, the
analog of each reference example's ``main()`` (e.g.
examples/TwoPhaseSolver.cpp:117-404): output directory, data writer and
monitor channels, time loop with save cadence.

Observation. Every monitor quantity of a state is computed on the state's
device and stacked into one 1-D tensor, which is copied to the host once
(``core.sync.fetch``); the loop's end test, the monitor row, the
non-converged warning, the NaN tripwire and the log line all read that one
copy. The output planes are stacked likewise and copied once per written
frame. So a driver step costs the step's own host syncs plus one, plus one
more on a step that writes a frame; the initial state is read once, when
the ``Simulation`` is built. The driver only observes: ``run`` returns the
state of as many direct calls of the case's step.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from fluidsolver_tpu_torch.cases import Case
from fluidsolver_tpu_torch.core import sync
from fluidsolver_tpu_torch.io.monitor import Monitor
from fluidsolver_tpu_torch.io.writer import SaveCadence, make_data_writer
from fluidsolver_tpu_torch.ops import stencil
from fluidsolver_tpu_torch.solvers.state import end_tolerance


def _flow(state):
    """The flow fields of a state: a ``FlowState``, or the ``flow`` of a
    two-phase or immersed-interface state."""
    return getattr(state, "flow", state)


class Simulation:
    def __init__(
        self,
        case: Case,
        output_dir: Optional[str] = None,
        writer: str = "xdmf",
        dtype: Optional[torch.dtype] = None,
        device="cuda",
        save_output: bool = True,
        check_nan: bool = False,
        warn_nonconverged: bool = True,
    ):
        self.case = case
        self.grid = case.grid
        self.cfg = case.cfg
        self.dtype = torch.float32 if dtype is None else dtype
        # the concrete device ("cuda" -> "cuda:0"): the steps check it
        self.device = torch.empty(0, device=device).device
        self.state = case.make_state(self.dtype, self.device)
        self.step = case.make_step(self.dtype, self.device)
        self.save_output = save_output
        # numeric tripwires: the reference NaN-poisons scratch fields and
        # asserts on the Poisson RHS (SURVEY.md §5); here the per-step check
        # is optional and rides on the one observed copy per step
        self.check_nan = check_nan
        # HYPRE-non-convergence warning analog
        # (src/LinearSolver_StructHypre.hpp:174-189)
        self.warn_nonconverged = warn_nonconverged
        self.n_steps = 0

        if output_dir is None:
            output_dir = os.path.join("output", case.name)
        self.output_dir = output_dir
        # the host copies and the state each was taken from
        self._scalars_of = self._fields_of = None
        self.observe()
        if save_output:
            os.makedirs(output_dir, exist_ok=True)
            self._setup_writers(writer)

    # -- observation ------------------------------------------------------
    def _scalar_values(self, state) -> dict:
        """The monitor quantities of ``state``, name -> 0-d tensor."""
        g = self.grid
        two = self.case.two_phase
        fl = _flow(state)
        div = stencil.divergence(fl.U, fl.V, g.dx, g.dy)
        out = {
            "time": fl.t,
            "dt": fl.dt,
            "max(U)": torch.max(torch.abs(fl.U)),
            "max(V)": torch.max(torch.abs(fl.V)),
            # interior only: ghost-ring entries of the divergence array
            # are not defined (reference computes it on the interior box,
            # src/Operators.hpp:32-41)
            "max(div)": torch.max(torch.abs(div[1:-1, 1:-1])),
            "res(p)": fl.p_res,
            "iter(p)": fl.p_iter,
        }
        if self.check_nan:
            for f in ("U", "V", "p"):
                out[f"nan({f})"] = torch.any(torch.isnan(getattr(fl, f)))
        if two:
            out.update({
                "min(curv)": torch.min(state.curv),
                "max(curv)": torch.max(state.curv),
                "min(vof)": torch.min(state.vf),
                "max(vof)": torch.max(state.vf),
                "int(vof)": torch.sum(state.vf[1:-1, 1:-1]) * g.dx * g.dy,
            })
        return out

    def _field_values(self, state) -> dict:
        """The output planes of ``state`` (cell-centred, ghosted)."""
        two = self.case.two_phase
        fl = _flow(state)
        g = self.grid
        out = {
            "pressure": fl.p,
            "divergence": stencil.divergence(fl.U, fl.V, g.dx, g.dy),
            "velocity_x": stencil.interp_u_center(fl.U),
            "velocity_y": stencil.interp_v_center(fl.V),
        }
        if two:
            out.update({
                "VOF": state.vf,
                "curvature": state.curv,
                "viscosity": fl.visc,
                "density": stencil.interp_uv_center(fl.rho_u, fl.rho_v),
            })
        return out

    def observe(self) -> dict:
        """The monitor quantities of the current state, name -> float
        (flags as 0.0 / 1.0; ``iter(p)`` exact). Copied from the device once
        per state, in one counted host copy, and kept until the state
        changes."""
        if self._scalars_of is not self.state:
            vals = self._scalar_values(self.state)
            # every column is exact in float64 (p_iter is an int32)
            row = sync.fetch(torch.stack([v.to(torch.float64) for v in vals.values()]))
            self._scalars = dict(zip(vals, row.tolist()))
            self._scalars_of = self.state
        return self._scalars

    def _field(self, key: str):
        if self._fields_of is not self.state:
            vals = self._field_values(self.state)
            self._fields = dict(zip(vals, sync.fetch(torch.stack(list(vals.values())))))
            self._fields_of = self.state
        return self._fields[key]

    def _setup_writers(self, writer: str):
        self.writer = make_data_writer(self.output_dir, self.grid, prefer=writer)
        for name in ("pressure", "divergence"):
            self.writer.add_scalar(name, lambda k=name: self._field(k))
        self.writer.add_vector(
            "velocity",
            lambda: self._field("velocity_x"),
            lambda: self._field("velocity_y"),
        )
        if self.case.two_phase:
            for name in ("VOF", "curvature", "viscosity", "density"):
                self.writer.add_scalar(name, lambda k=name: self._field(k))

        self.monitor = Monitor(os.path.join(self.output_dir, "monitor.log"))
        mon = self.monitor
        for name in ("time", "dt", "max(U)", "max(V)", "max(div)", "res(p)"):
            mon.add_variable(lambda k=name: self.observe()[k], name)
        mon.add_variable(lambda: int(self.observe()["iter(p)"]), "iter(p)")
        if self.case.two_phase:
            for name in ("min(curv)", "max(curv)", "min(vof)", "max(vof)"):
                mon.add_variable(lambda k=name: self.observe()[k], name)
            init_int = self.observe()["int(vof)"]
            mon.add_variable(lambda: init_int - self.observe()["int(vof)"], "loss(vof)")

    def close(self):
        """Close the monitor and the data writer's files."""
        if self.save_output:
            self.monitor.close()
            if hasattr(self.writer, "close"):
                self.writer.close()

    # -- time loop ---------------------------------------------------------
    def run(self, t_end: Optional[float] = None, max_steps: int = 10_000_000,
            callback=None, log_every: int = 0):
        t_end = self.case.t_end if t_end is None else t_end
        cadence = SaveCadence(self.case.dt_write, t_end)
        if self.save_output:
            self.writer.write(self.observe()["time"])
            self.monitor.write()
        wall0 = time.perf_counter()
        n = 0
        t_tol = end_tolerance(self.dtype, t_end)
        while self.observe()["time"] < t_end - t_tol and n < max_steps:
            self.state = self.step(self.state, t_end)
            n += 1
            obs = self.observe()
            t, dt = obs["time"], obs["dt"]
            if self.warn_nonconverged:
                p_res = obs["res(p)"]
                if p_res > self.cfg.pressure_tol:
                    print(f"[{self.case.name}] WARNING: pressure solve did not "
                          f"converge at t={t:.6e}: residual = {p_res:.3e}")
            if self.check_nan:
                for fname in ("U", "V", "p"):
                    if obs[f"nan({fname})"]:
                        raise FloatingPointError(
                            f"NaN in {fname} at step {n}, t={t:.6e}"
                        )
            if self.save_output:
                self.monitor.write()
                if cadence(t, dt):
                    self.writer.write(t)
            if callback is not None:
                callback(self.state)
            if log_every and n % log_every == 0:
                print(f"[{self.case.name}] step {n}: t={t:.6e} dt={dt:.3e}")
        self.wall_time = time.perf_counter() - wall0
        self.n_steps = n
        return self.state


def main(argv=None) -> Simulation:
    import argparse

    from fluidsolver_tpu_torch.cases import get_case, list_cases

    ap = argparse.ArgumentParser(prog="fluidsolver_tpu_torch",
                                 description="Two-phase flow solver on PyTorch (CUDA)")
    ap.add_argument("case", choices=list_cases())
    ap.add_argument("--t-end", type=float, default=None)
    ap.add_argument("--output", default=None)
    ap.add_argument("--writer", default="xdmf", choices=["xdmf", "vtk"])
    ap.add_argument("--x64", action="store_true", help="float64 (default float32)")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--check-nan", action="store_true",
                    help="per-step NaN tripwire (read with the step's observed values)")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a torch.profiler Chrome trace of the run into DIR")
    ap.add_argument("--param", action="append", default=[], metavar="K=V",
                    help="case parameter override, e.g. --param ny=64")
    ap.add_argument("--device", default="cuda", help="torch device to run on (default cuda)")
    args = ap.parse_args(argv)

    params = {}
    for kv in args.param:
        k, v = kv.split("=", 1)
        try:
            params[k] = int(v)
        except ValueError:
            params[k] = float(v)
    case = get_case(args.case, **params)
    sim = Simulation(case, output_dir=args.output, writer=args.writer,
                     dtype=torch.float64 if args.x64 else torch.float32,
                     device=args.device, check_nan=args.check_nan)
    try:
        if args.profile:
            from fluidsolver_tpu_torch.utils.profiling import device_trace

            with device_trace(args.profile, sim.device):
                sim.run(t_end=args.t_end, log_every=args.log_every)
        else:
            sim.run(t_end=args.t_end, log_every=args.log_every)
    finally:
        sim.close()
    print(f"[{case.name}] finished: {sim.n_steps} steps in {sim.wall_time:.2f}s "
          f"-> {sim.output_dir}")
    return sim


if __name__ == "__main__":
    main()
