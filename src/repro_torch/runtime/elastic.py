"""Elastic scaling: rebuild the mesh from surviving devices and re-shard
(port of ``repro.runtime.elastic``).

Failure model: a pod/node drops out (heartbeat loss); the controller
1. chooses the largest viable mesh from the surviving device list
   (``plan_mesh``): the data axis shrinks (DP degree is elastic), the model
   axis is preserved (TP degree is a property of the compiled program);
2. restores the latest checkpoint with the *new* sharding
   (``CheckpointManager.restore(..., shardings=new)``), or, if the state is
   still live, re-shards it in place (``reshard_state``);
3. rescales the data pipeline (global batch per shard) and resumes.

``Heartbeat`` is the liveness primitive: workers ping; the controller
declares death after ``timeout`` (:class:`repro_torch.fleet.FleetController`
arms one per worker).  All of this is host-side orchestration, testable on
the CPU by simulating device loss.  The meshes are the port's
(:class:`repro_torch.core.mesh.Mesh`, one process holding every device).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.mesh import Mesh, NamedSharding, device_put, tree_map


@dataclasses.dataclass
class ElasticConfig:
    model_axis: int = 16  # TP degree is fixed by the compiled program
    min_data_axis: int = 1


def plan_mesh(
    n_devices: int, cfg: ElasticConfig = ElasticConfig()
) -> Tuple[int, int]:
    """Largest (data, model) grid fitting the surviving device count."""
    model = cfg.model_axis
    if n_devices < model:
        raise RuntimeError(
            f"{n_devices} devices cannot sustain model axis {model}"
        )
    data = n_devices // model
    if data < cfg.min_data_axis:
        raise RuntimeError("insufficient devices for minimum data parallelism")
    return data, model


def rebuild_mesh(devices: Sequence, cfg: ElasticConfig = ElasticConfig()) -> Mesh:
    """A ``("data", "model")`` mesh of the largest grid ``plan_mesh``
    finds in ``devices``."""
    data, model = plan_mesh(len(devices), cfg)
    grid = np.asarray(list(devices[: data * model]), dtype=object).reshape(data, model)
    return Mesh(grid, ("data", "model"))


def reshard_state(state, mesh: Mesh, spec_fn):
    """Re-place live state onto a new mesh (``spec_fn(mesh, state)`` gives
    a tree of :class:`~repro_torch.core.mesh.PartitionSpec` with
    ``state``'s structure down to them): a tree of
    :class:`~repro_torch.core.mesh.Sharded` leaves, each device's blocks
    in buffers of its own."""
    specs = spec_fn(mesh, state)
    shardings = tree_map(lambda s, _: NamedSharding(mesh, s), specs, None)
    return device_put(state, shardings, copy=True)


class Heartbeat:
    """Liveness tracking: worker -> last-ping time; death after timeout."""

    def __init__(self, workers: Sequence[int], timeout_s: float = 30.0):
        self.timeout = timeout_s
        now = time.time()
        self.last: Dict[int, float] = {w: now for w in workers}

    def ping(self, worker: int, now: Optional[float] = None):
        self.last[worker] = time.time() if now is None else now

    def dead(self, now: Optional[float] = None) -> List[int]:
        t = time.time() if now is None else now
        return [w for w, last in self.last.items() if t - last > self.timeout]

    def remove(self, worker: int):
        self.last.pop(worker, None)


@dataclasses.dataclass
class ElasticEvent:
    step: int
    lost: List[int]
    new_mesh_shape: Tuple[int, int]
    action: str  # "resharded-live" | "restored-from-checkpoint"


class ElasticController:
    """Ties heartbeat, mesh planning and checkpoint restore together."""

    def __init__(self, heartbeat: Heartbeat, cfg: ElasticConfig = ElasticConfig()):
        self.hb = heartbeat
        self.cfg = cfg
        self.events: List[ElasticEvent] = []

    def check(self, step: int, devices_by_worker: Dict[int, list], now=None):
        """Returns (surviving devices, event) — ``None`` if healthy."""
        dead = self.hb.dead(now)
        if not dead:
            return None
        for w in dead:
            self.hb.remove(w)
        surviving = [
            d
            for w, devs in devices_by_worker.items()
            if w not in dead
            for d in devs
        ]
        shape = plan_mesh(len(surviving), self.cfg)
        ev = ElasticEvent(step, dead, shape, "resharded-live")
        self.events.append(ev)
        return surviving, ev
