"""Device-to-host reads that steer the solver's control flow.

The JAX package keeps its loops on the device (``lax.while_loop`` in PCG,
``lax.cond(dt > 0)`` in the step). The port runs them as Python loops, so
each loop test reads a scalar back to the host and waits for the device.
Every such read goes through :func:`read` so that runs can report the host
syncs per step; the driver's one copy of its observed values per step (and
per written frame) goes through :func:`fetch`. The host's wait in each
runs inside the profiler range ``SYNC_RANGE``.
"""

from __future__ import annotations

import numpy as np
import torch

from fluidsolver_tpu_torch.utils import profiling

# the profiler range around the blocking copy of each counted read, so that
# a trace can tell the device's idle time behind a host read from the rest
SYNC_RANGE = "twophase.sync"

count = 0


def read(t: torch.Tensor):
    """``t.item()``, counted."""
    global count
    count += 1
    with profiling.annotate(SYNC_RANGE):
        return t.item()


def fetch(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a numpy array, counted."""
    global count
    count += 1
    with profiling.annotate(SYNC_RANGE):
        host = t.detach().cpu()
    return host.numpy()
