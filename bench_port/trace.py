"""Reading a ``torch.profiler`` trace of one block of driver steps.

The arithmetic is that of the port's chip check (``chip_smoke.py``
``device_trace`` / ``device_events`` / ``profile_steps``, copied here so
that a change to the program cannot change it): one discarded warm-up
cycle (a device sleep) brings the device trace up before the profiled
block, the schedule's own ``ProfilerStep`` span is dropped, and a device
operation belongs to a profiler range when it starts inside that range's
span on the device timeline.
"""

from __future__ import annotations

import contextlib
import dataclasses

# ranges the program opens around its layers (``solvers/twophase.py``,
# ``poisson/cg.py``); their device-side spans are annotations, not work
RANGE_PREFIXES = ("twophase.", "pcg.")


@dataclasses.dataclass
class Op:
    name: str
    start: float   # us on the profiler's clock
    end: float

    @property
    def us(self) -> float:
        return self.end - self.start


@dataclasses.dataclass
class Trace:
    ops: list          # device operations (kernels, copies, sets), in start order
    ranges: list       # device-side spans of the program's ranges
    host: list         # host-side events (ranges and operators)
    wall_s: float      # host clock over the profiled block
    steps: int         # driver steps in the profiled block

    def busy_s(self) -> float:
        """Seconds in which some device operation ran (the union of the
        operations' intervals)."""
        total, reach = 0.0, float("-inf")
        for op in self.ops:
            if op.end > reach:
                total += op.end - max(op.start, reach)
                reach = op.end
        return total / 1e6

    def range_us(self, name: str) -> float:
        """Device time of the operations that start inside ``name``'s spans."""
        spans = [(r.start, r.end) for r in self.ranges if r.name == name]
        return sum(op.us for op in self.ops if any(a <= op.start < b for a, b in spans))

    def kernel(self, pattern: str) -> list:
        """The device operations whose name contains ``pattern``."""
        return [op for op in self.ops if pattern in op.name]

    def top_ops(self, n: int = 10) -> list:
        by_name: dict = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) + op.us
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:120], us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = 10) -> list:
        """The ``n`` longest gaps between device operations, each named by
        the innermost host event open at its middle."""
        gaps, reach = [], None
        for op in self.ops:
            if reach is not None and op.start > reach:
                gaps.append((op.start - reach, reach, op.start))
            reach = op.end if reach is None else max(reach, op.end)
        out = []
        for us, a, b in sorted(gaps, reverse=True)[:n]:
            mid = 0.5 * (a + b)
            open_ = [h for h in self.host if h.start <= mid < h.end]
            name = max(open_, key=lambda h: h.start).name if open_ else "(no host event)"
            out.append([name[:120], us / 1e6])
        return out


@contextlib.contextmanager
def device_trace():
    """torch.profiler (CPU and CUDA) over the block, after one warm-up
    cycle (a device sleep, its events discarded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize()
        prof.step()
        yield prof
        torch.cuda.synchronize()
        prof.step()


def read(prof, wall_s: float, steps: int) -> Trace:
    import torch

    ops, ranges, host = [], [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            if e.name.startswith("ProfilerStep"):
                continue
            item = Op(e.name, tr.start, tr.end)
            (ranges if e.name.startswith(RANGE_PREFIXES) else ops).append(item)
        else:
            host.append(Op(e.name, tr.start, tr.end))
    ops.sort(key=lambda op: op.start)
    return Trace(ops=ops, ranges=ranges, host=host, wall_s=wall_s, steps=steps)
