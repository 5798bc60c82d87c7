"""Device-to-host reads that steer the solver's control flow.

The JAX package keeps its loops on the device (``lax.while_loop`` in PCG,
``lax.cond(dt > 0)`` in the step). The port runs them as Python loops, so
each loop test reads a scalar back to the host and waits for the device.
Every such read goes through :func:`read` so that runs can report the host
syncs per step.
"""

from __future__ import annotations

import torch

count = 0


def read(t: torch.Tensor):
    """``t.item()``, counted."""
    global count
    count += 1
    return t.item()
