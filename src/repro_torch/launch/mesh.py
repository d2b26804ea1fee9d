"""Production and local meshes (port of ``repro.launch.mesh``).

Functions, never module-level constants, as in the reference.  Both take
the device the mesh is built over; a device may repeat (A6): on the CPU and
on one card the 16 x 16 and 2 x 16 x 16 meshes are that one device 256 or
512 times, which is enough for the sharding plans and the dry run (neither
allocates per device), and a ``make_local_mesh`` step runs every shard on
it in turn.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.mesh import Mesh
from repro_torch.device import resolve_device


def _grid(device, shape) -> np.ndarray:
    dev = resolve_device(device)
    grid = np.empty(int(np.prod(shape)), dtype=object)
    grid[:] = [dev] * grid.size
    return grid.reshape(shape)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16x16 = 256 shards per pod; 2 pods = 512 shards multi-pod, all on
    ``device`` (``cuda`` unless given)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(_grid(device, shape), axes)


def make_local_mesh(model: int = 1, data: int = 1, device=None) -> Mesh:
    """A ``(data, model)`` mesh of ``data * model`` shards on ``device``
    (the reference's spreads whatever devices exist over ``data``)."""
    return Mesh(_grid(device, (data, model)), ("data", "model"))
