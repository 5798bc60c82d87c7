"""Tracing/profiling utilities: port of ``fluidsolver_tpu.utils.profiling``.

The reference's observability is Igor::ScopeTimer wall-clock scopes and
optional Score-P instrumentation (SURVEY.md §5). Here: plain wall-clock
scopes, ``torch.profiler`` traces exported as Chrome traces (open them in
Perfetto or chrome://tracing), and named ranges that show in those traces.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def scope_timer(name: str):
    """Igor::ScopeTimer analog: prints the elapsed wall time of the scope."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        print(f"[{name}] took {time.perf_counter() - t0:.3f}s")


@contextlib.contextmanager
def device_trace(log_dir: str, device="cuda"):
    """Profile the scope: host activity, and the card's kernels when
    ``device`` is a CUDA device. The trace is written to
    ``log_dir/trace.json`` when the scope ends."""
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def annotate(name: str):
    """Named trace range for step phases (shows up in the profile)."""
    return record_function(name)
