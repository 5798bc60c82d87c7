"""Tracing/profiling utilities: port of ``fluidsolver_tpu.utils.profiling``.

The reference's observability is Igor::ScopeTimer wall-clock scopes and
optional Score-P instrumentation (SURVEY.md §5). Here: ``torch.profiler``
traces exported as Chrome traces (open them in Perfetto or
chrome://tracing), and the named spans the program opens at its stage
boundaries (:func:`annotate`), which show in those traces on the
profiler's clock beside the device operations they enclose.
"""

from __future__ import annotations

import contextlib
import os

import torch
from torch.profiler import ProfilerActivity, profile, record_function, schedule

TRACE_FILE = "trace.json"
_NULL = contextlib.nullcontext()


def annotate(name: str, *dims: int):
    """A profiler range named ``name`` (with ``dims``: ``name.<d0>x<d1>...``,
    e.g. the shape a kernel works on) while a profiler records; otherwise a
    shared null context, so that with tracing off a span costs one flag
    test and its name is never built. Every range the program opens goes
    through here.

    On the device timeline the profiler spans a range from the first to
    the last device operation launched in it outside any range nested in
    it (it tags each launch with the innermost range only), and gives a
    range with no such operation no device span at all. So a range whose
    device span must hold the work of the ranges nested in it starts and
    ends with device work of its own, as the step's stages and the PCG
    solve do."""
    if not torch.autograd._profiler_enabled():
        return _NULL
    return record_function(f"{name}.{'x'.join(map(str, dims))}" if dims else name)


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile the scope: host activity, and the card's kernels when
    ``device`` is a CUDA device. The trace is written to
    ``log_dir/trace.json`` when the scope ends. On a CUDA device one
    warm-up cycle (a device sleep, its events discarded) comes first: a
    cold device trace can lose the scope's first kernels."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, TRACE_FILE)
    if torch.device(device).type != "cuda":
        prof = profile(activities=[ProfilerActivity.CPU])
        try:
            with prof:
                yield prof
        finally:
            prof.export_chrome_trace(path)
        return
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        torch.cuda._sleep(1_000_000)
        torch.cuda.synchronize(device)
        prof.step()
        yield prof
        torch.cuda.synchronize(device)
        prof.step()
