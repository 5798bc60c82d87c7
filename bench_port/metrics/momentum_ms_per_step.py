"""Device ms per step of the operations that start inside the program's
``twophase.momentum`` range (each subiteration's momentum update with the
density fill, the velocity BCs, the outflow fix and the flow and IB
forcing), over the profiled block; nothing where the range is absent.

It also holds the sweep that the readers of the program's other spans
share: :func:`innermost` finds, for each of a sorted list of times, the
innermost span holding it, in one pass over the spans and the times (a
channel block has about 10^4 spans and 10^5 device operations, too many to
test every pair)."""

RANGE = "twophase.momentum"


def innermost(spans, times) -> list:
    """For each of ``times`` (ascending), the innermost of ``spans`` (each
    with ``start`` and ``end``) with start <= t < end, or None. Spans nest
    or are disjoint; where they overlap otherwise, a time held by any of
    them still gets one that holds it."""
    order = sorted(spans, key=lambda s: (s.start, -s.end))
    held, open_, i = [], [], 0
    for t in times:
        while i < len(order) and order[i].start <= t:
            open_.append(order[i])
            i += 1
        while open_ and open_[-1].end <= t:
            open_.pop()
        held.append(open_[-1] if open_ else None)
    return held


def range_ms_per_step(trace, name: str):
    """``trace.range_us(name)`` in ms per step, in one sweep; None where
    the trace has no span of ``name``."""
    if trace is None:
        return None
    spans = [r for r in trace.ranges if r.name == name]
    if not spans:
        return None
    held = innermost(spans, [op.start for op in trace.ops])
    return sum(op.us for op, span in zip(trace.ops, held) if span is not None) / 1e3 / trace.steps


def read(run):
    return range_ms_per_step(run.trace, RANGE)
