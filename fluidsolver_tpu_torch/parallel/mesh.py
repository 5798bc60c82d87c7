"""The x-slab mesh and its collectives.

``SlabMesh(devices)`` is an ordered list of devices along grid-x with the
axis name ``"x"``: the port's one-axis ``jax.sharding.Mesh``. A device may
repeat, so ``SlabMesh(["cuda:0"] * 4)`` is four slabs on one card, as the
JAX tests' eight virtual CPU devices are eight slabs on one CPU.

A sharded plane is a list of per-slab tensors, slab ``i`` on
``devices[i]``. The collectives that the JAX package's ``shard_map`` bodies
use become plain functions over such lists:

- ``lax.ppermute`` with zeros at the mesh edges -> :func:`extend_x`;
- the ghost-row refresh of ``halo.halo_exchange_x`` -> :func:`halo_exchange_x`;
- ``lax.psum`` / ``lax.pmax`` of scalars -> :func:`psum` / :func:`pmax`, in
  rank order on ``devices[0]``, with no host read;
- ``lax.all_gather(tiled=True)`` -> :func:`all_gather_rows` on ``devices[0]``;
- ``lax.dynamic_slice_in_dim`` back to a slab -> :func:`scatter_rows`.

``lax.axis_index`` is the loop index and ``lax.axis_size`` is ``len(mesh)``.
A global-view field lives on ``devices[0]``. A slab's kernels launch with
its device current (:func:`current`), so slabs on several cards launch on
their own card.
"""

from __future__ import annotations

import contextlib

import torch

AXIS = "x"


class SlabMesh:
    """An ordered list of devices along grid-x, axis ``"x"``."""

    def __init__(self, devices):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {AXIS: len(self.devices)}

    def __len__(self) -> int:
        return len(self.devices)


def _rows(a: torch.Tensor, lo: int, hi: int, device) -> torch.Tensor:
    return a[lo:hi].to(device)


def extend_x(mesh: SlabMesh, slabs: list, w: int) -> list:
    """Each slab extended by ``w`` rows per side from its neighbours (copied
    to the slab's device); the slabs at the mesh edges get zero rows there,
    as ``lax.ppermute`` gives an absent source, which reproduces the global
    code's zero-padded shifts."""
    n = len(mesh)
    out = []
    for i, f in enumerate(slabs):
        if w > f.shape[0]:
            raise ValueError(f"a {w}-row halo is wider than a {f.shape[0]}-row slab")
        dev = mesh.devices[i]
        zeros = f.new_zeros((w,) + tuple(f.shape[1:]))
        left = _rows(slabs[i - 1], -w, None, dev) if i > 0 else zeros
        right = _rows(slabs[i + 1], 0, w, dev) if i < n - 1 else zeros
        out.append(torch.cat([left, f, right], dim=0))
    return out


def halo_exchange_x(mesh: SlabMesh, slabs: list, periodic: bool = False) -> list:
    """Refresh the one-row x-ghost layers of each slab (first and last rows)
    from the neighbours' outermost interior rows. Without ``periodic`` the
    ghosts at the mesh edges keep their values (the physical BCs own them)."""
    n = len(mesh)
    out = []
    for i, f in enumerate(slabs):
        dev = mesh.devices[i]
        f = f.clone()
        if i > 0 or periodic:
            f[0] = slabs[(i - 1) % n][-2].to(dev)
        if i < n - 1 or periodic:
            f[-1] = slabs[(i + 1) % n][1].to(dev)
        out.append(f)
    return out


def psum(mesh: SlabMesh, values: list) -> torch.Tensor:
    """The sum of the per-slab 0-d tensors, added in rank order on
    ``devices[0]``."""
    total = values[0].to(mesh.devices[0])
    for v in values[1:]:
        total = total + v.to(mesh.devices[0])
    return total


def pmax(mesh: SlabMesh, values: list) -> torch.Tensor:
    """The largest of the per-slab 0-d tensors, on ``devices[0]``."""
    total = values[0].to(mesh.devices[0])
    for v in values[1:]:
        total = torch.maximum(total, v.to(mesh.devices[0]))
    return total


def all_gather_rows(mesh: SlabMesh, slabs: list) -> torch.Tensor:
    """The slabs stacked along x into one global plane on ``devices[0]``."""
    return torch.cat([s.to(mesh.devices[0]) for s in slabs], dim=0)


def scatter_rows(mesh: SlabMesh, a: torch.Tensor, rows: int) -> list:
    """``a`` cut into slabs of ``rows`` rows (the first ``len(mesh) * rows``
    of it), each moved to its device."""
    if a.shape[0] < rows * len(mesh):
        raise ValueError(f"{a.shape[0]} rows cannot fill {len(mesh)} slabs of {rows}")
    return [a[i * rows:(i + 1) * rows].to(d) for i, d in enumerate(mesh.devices)]


def broadcast(mesh: SlabMesh, t) -> list:
    """A replicated value (a tensor of ``devices[0]`` or a Python number)
    on every slab's device."""
    if not torch.is_tensor(t):
        return [t] * len(mesh)
    return [t.to(d) for d in mesh.devices]


def current(device: torch.device):
    """The context in which ``device`` is the current CUDA device (nothing
    to do for the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()
