"""The share of the profiled block's idle device time that the device
spends behind a host read, in %: of the gaps between device operations
(as ``Trace.idle_gaps`` finds them), those that open while the host is
inside the program's ``twophase.sync`` range (the blocking copy of a
counted read, ``core/sync.py``), by length, over all of them. The rest is
idle while the host issues work. Nothing where the trace has no such
range or no gap."""

from bench_port.metrics.momentum_ms_per_step import innermost

RANGE = "twophase.sync"


def read(run):
    tr = run.trace
    if tr is None:
        return None
    syncs = [h for h in tr.host if h.name == RANGE]
    gaps, reach = [], None
    for op in tr.ops:
        if reach is not None and op.start > reach:
            gaps.append((reach, op.start - reach))
        reach = op.end if reach is None else max(reach, op.end)
    if not syncs or not gaps:
        return None
    held = innermost(syncs, [opened for opened, _ in gaps])
    at_sync = sum(us for (_, us), span in zip(gaps, held) if span is not None)
    return 100.0 * at_sync / sum(us for _, us in gaps)
