"""Checkpoint / resume of simulation states: port of the npz half of
``fluidsolver_tpu.io.checkpoint``.

A checkpoint is one .npz of the state's leaves ``arr_0 ... arr_k`` in the
JAX package's pytree order: dataclass fields in declaration order, nested
dataclasses flattened in place. ``FlowState`` and ``TwoPhaseState``
declare their fields in the JAX package's order, so a checkpoint written
by either package restores into the other. ``restore`` rebuilds through a
template, which gives each leaf's dtype and device.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _leaves(state) -> list:
    out = []
    for f in dataclasses.fields(state):
        v = getattr(state, f.name)
        out.extend(_leaves(v) if dataclasses.is_dataclass(v) else [v])
    return out


def _rebuild(template, leaves):
    kwargs = {}
    for f in dataclasses.fields(template):
        v = getattr(template, f.name)
        kwargs[f.name] = _rebuild(v, leaves) if dataclasses.is_dataclass(v) else next(leaves)
    return dataclasses.replace(template, **kwargs)


def save(path: str, state) -> None:
    np.savez(path, *[leaf.detach().cpu().numpy() for leaf in _leaves(state)])


def restore(path: str, template):
    leaves = _leaves(template)
    with np.load(path) as data:
        if len(data.files) != len(leaves):
            raise ValueError(f"checkpoint has {len(data.files)} leaves; template needs {len(leaves)}")
        arrays = [data[f"arr_{i}"] for i in range(len(leaves))]
    new = (torch.as_tensor(a, dtype=leaf.dtype, device=leaf.device) for a, leaf in zip(arrays, leaves))
    return _rebuild(template, new)
