"""Distributed hierarchical associative arrays (port of
``repro.core.distributed``).

For the paper's design, independent instances with no collective on the
update path, the entry point is :class:`repro_torch.d4m.D4MStream`
(``StreamConfig(devices=D)``, or ``mesh=``); :class:`ParallelHierStream`
is a deprecation shim over it.

Beyond the paper, :class:`ShardedAssoc` holds one *global* array sharded
by row-key range: each shard buckets its batch by owner, one
``all_to_all`` exchanges the buckets, and each shard ingests its own
range.  Everything runs in one process over a
:class:`~repro_torch.core.mesh.Mesh` (one hierarchy a mesh device, the
collectives explicit copies between shards), as the reference's
``shard_map`` program runs under one controller.
"""
from __future__ import annotations

import warnings
from typing import Sequence, Tuple

import torch

from . import assoc, hierarchical, multistream
from . import mesh as mesh_mod
from .assoc import PAD
from .hierarchical import HierAssoc
from .mesh import Mesh
from .multistream import MultiStreamEngine
from .semiring import PLUS_TIMES, Semiring


# ---------------------------------------------------------------------------
# paper-faithful: independent instances, zero update-path collectives
# ---------------------------------------------------------------------------

class ParallelHierStream:
    """DEPRECATED: one independent hierarchical array per device.

    A shim over the session API: construction builds a
    :class:`repro_torch.d4m.D4MStream` on the given mesh (or, for a mesh
    used on a subset of its axes, a :class:`MultiStreamEngine`) and
    forwards to its engine.  New code uses the session::

        sess = repro_torch.d4m.D4MStream(
            repro_torch.d4m.StreamConfig(cuts=..., top_capacity=...,
                                         batch_size=..., instances_per_device=K),
            mesh=Mesh([device] * D, ("data",)))
    """

    def __init__(
        self,
        mesh: Mesh,
        cuts: Sequence[int],
        top_capacity: int,
        batch_size: int,
        sr: Semiring = PLUS_TIMES,
        axis_names: Tuple[str, ...] | None = None,
        instances_per_device: int = 1,
    ):
        warnings.warn(
            "ParallelHierStream is deprecated; use repro_torch.d4m.D4MStream "
            "(the unified session API)",
            DeprecationWarning,
            stacklevel=2,
        )
        if axis_names is not None and tuple(axis_names) != tuple(mesh.axis_names):
            # sub-axis meshes predate the session API: the direct engine
            self.engine = MultiStreamEngine(
                mesh, cuts, top_capacity, batch_size,
                instances_per_device=instances_per_device, sr=sr, axis_names=axis_names,
            )
        else:
            from repro_torch.d4m import D4MStream, StreamConfig

            self.session = D4MStream(
                StreamConfig(
                    cuts=tuple(int(c) for c in cuts),
                    top_capacity=int(top_capacity),
                    batch_size=int(batch_size),
                    semiring=sr,
                    instances_per_device=int(instances_per_device),
                    engine="mesh",
                ),
                mesh=mesh,
            )
            self.engine = self.session.engine
        self.mesh = mesh
        self.cuts = self.engine.cuts
        self.sr = sr
        self.batch_size = batch_size
        self.axes = self.engine.axes
        self.n_instances = self.engine.n_instances
        self.update = self.engine.update
        self.global_nnz = self.engine.global_nnz

    def init_state(self) -> Tuple[HierAssoc, ...]:
        """Per-device hierarchies, one a mesh device."""
        return self.engine.init_state()

    def shard_stream(self, rows, cols, vals):
        """Place an ``[n_instances, B]`` triple batch instance-major."""
        return self.engine.shard_stream(rows, cols, vals)

    def ingest(self, h, rows, cols, vals):
        """Hash-route a flat global triple batch to every instance and update."""
        return self.engine.ingest(h, rows, cols, vals)


# ---------------------------------------------------------------------------
# beyond paper: key-range-sharded global array with all_to_all routing
# ---------------------------------------------------------------------------

def owner_of(rows: torch.Tensor, n_shards: int, key_space: int) -> torch.Tensor:
    """Contiguous row-range ownership: shard i owns rows in
    ``[i*key_space/n, (i+1)*key_space/n)``."""
    per = max(1, key_space // n_shards)
    return torch.clamp(rows // per, 0, n_shards - 1).to(torch.int32)


def bucket_by_owner(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_shards: int,
    key_space: int,
    slot_cap: int,
    sr: Semiring = PLUS_TIMES,
):
    """Group a local triple batch into ``n_shards`` fixed-size slots, by a
    quadratic rank (the readable version, kept for tests; the engine uses
    :func:`bucket_by_owner_sorted`).  Returns ``[n_shards, slot_cap]``
    arrays for ``all_to_all`` and the count of triples beyond a full slot."""
    owner = owner_of(rows, n_shards, key_space)
    live = rows != PAD
    owner = torch.where(live, owner, n_shards)  # park pads in a virtual shard
    # rank within bucket = number of earlier entries with the same owner
    same = owner[None, :] == owner[:, None]
    earlier = torch.ones_like(same).tril(-1)
    rank = (same & earlier).sum(dim=1, dtype=torch.int32)
    dropped = ((rank >= slot_cap) & live).sum(dtype=torch.int32)
    total = n_shards * slot_cap
    slot = torch.where((rank < slot_cap) & live, owner.to(torch.int64) * slot_cap + rank, total)

    def place(src, fill, dtype):
        out = torch.full((total + 1,), fill, dtype=dtype, device=rows.device)
        return out.scatter_(0, slot, src)[:total].reshape(n_shards, slot_cap)

    return (
        place(rows.to(torch.int32), PAD, torch.int32),
        place(cols.to(torch.int32), PAD, torch.int32),
        place(vals, sr.zero_as(vals.dtype), vals.dtype),
        dropped,
    )


def bucket_by_owner_sorted(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_shards: int,
    key_space: int,
    slot_cap: int,
    sr: Semiring = PLUS_TIMES,
):
    """Bucketing by a stable sort (:func:`multistream.scatter_to_slots`,
    shared with the hash router; only the owner function differs)."""
    owner = owner_of(rows, n_shards, key_space)
    live = rows != PAD
    return multistream.scatter_to_slots(owner, live, rows, cols, vals, n_shards, slot_cap, sr)


class ShardedAssoc:
    """A single global hierarchical array, sharded by row-key range over
    ``axis`` of ``mesh``.

    The state is one hierarchy a mesh device (a tuple in
    :attr:`Mesh.device_list` order; replicated over the mesh's other
    axes).  :meth:`update` buckets each shard's batch by owner, exchanges
    the buckets with one ``all_to_all`` each for rows, cols and vals, and
    ingests each shard's own ``D * slot_cap`` triples
    (``hierarchical.update_triples``: ``sort_dedup`` and ``merge_add`` on
    the card); the dropped counts are summed with one ``psum``.  A query
    for a key is answered by its owner.
    """

    def __init__(
        self,
        mesh: Mesh,
        axis: str,
        cuts: Sequence[int],
        top_capacity: int,
        batch_size: int,
        key_space: int,
        slot_cap: int | None = None,
        sr: Semiring = PLUS_TIMES,
    ):
        self.mesh = mesh
        self.axis = axis
        self.n_shards = mesh.shape[axis]
        self.key_space = key_space
        self.cuts = tuple(int(c) for c in cuts)
        self.sr = sr
        self.top_capacity = int(top_capacity)
        # worst case a device's whole batch goes to one owner
        self.slot_cap = slot_cap or batch_size
        self.ingest_cap = self.n_shards * self.slot_cap
        self.other_axes = tuple(a for a in mesh.axis_names if a != axis)
        self.sharding = mesh_mod.NamedSharding(mesh, mesh_mod.P(axis))
        self._index = mesh.axis_index(axis)

    def init_state(self) -> Tuple[HierAssoc, ...]:
        return tuple(
            hierarchical.init(self.cuts, self.top_capacity, self.ingest_cap, self.sr, device=dev)
            for dev in self.mesh.device_list
        )

    def _local(self, x):
        """Each device's ``[B]`` batch of an ``[n_shards, B]`` value."""
        if not isinstance(x, mesh_mod.Sharded):
            x = mesh_mod.device_put(x, self.sharding)
        return [s[0] for s in x.shards]

    def update(self, h, rows, cols, vals):
        """``(h, dropped)``: one exchange and ingest on every shard."""
        mesh, axis, n = self.mesh, self.axis, self.n_shards
        r, c, v = self._local(rows), self._local(cols), self._local(vals)
        buckets = [
            bucket_by_owner_sorted(r[i], c[i], v[i], n, self.key_space, self.slot_cap, self.sr)
            for i in range(mesh.size)
        ]
        br, bc, bv = (mesh.all_to_all([b[j] for b in buckets], axis) for j in range(3))
        h = tuple(
            hierarchical.update_triples(
                h[i], br[i].reshape(-1), bc[i].reshape(-1), bv[i].reshape(-1), self.cuts, self.sr
            )
            for i in range(mesh.size)
        )
        dropped = mesh.psum([b[3] for b in buckets], axis)
        for ax in self.other_axes:
            dropped = mesh.pmax(dropped, ax)
        return h, dropped[0]

    def get(self, h, r, c) -> torch.Tensor:
        """``A(r, c)``: the owner's value, summed with the other shards'
        zeros by one ``psum``."""
        mesh = self.mesh
        vals = []
        for i, hi in enumerate(h):
            dev = mesh.device_list[i]
            ri = torch.as_tensor(r, dtype=torch.int32).to(dev)
            ci = torch.as_tensor(c, dtype=torch.int32).to(dev)
            snap = hierarchical.snapshot(hi, cap=hi.layers[-1].capacity, sr=self.sr)
            val = assoc.get(snap, ri, ci, self.sr)
            mine = owner_of(ri, self.n_shards, self.key_space) == self._index[i]
            vals.append(torch.where(mine, val, torch.full_like(val, self.sr.zero_as(val.dtype))))
        out = mesh.psum(vals, self.axis)
        for ax in self.other_axes:
            out = mesh.pmax(out, ax)
        return out[0]
