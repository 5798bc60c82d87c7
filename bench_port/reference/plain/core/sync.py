"""Device-to-host reads that steer the solver's control flow.

The JAX package keeps its loops on the device (``lax.while_loop`` in PCG,
``lax.cond(dt > 0)`` in the step). The port runs them as Python loops, so
each loop test reads a scalar back to the host and waits for the device.
Every such read goes through :func:`read` so that runs can report the host
syncs per step; the driver's one copy of its observed values per step (and
per written frame) goes through :func:`fetch`.
"""

from __future__ import annotations

import numpy as np
import torch

count = 0


def read(t: torch.Tensor):
    """``t.item()``, counted."""
    global count
    count += 1
    return t.item()


def fetch(t: torch.Tensor) -> np.ndarray:
    """A host copy of ``t`` as a numpy array, counted."""
    global count
    count += 1
    return t.detach().cpu().numpy()
