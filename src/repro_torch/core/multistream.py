"""Instance-packed multi-stream state, hash routing and the mesh engine
(port of ``repro.core.multistream``).

K independent hierarchies live in one :class:`HierAssoc` whose every leaf
has a leading ``[K]`` axis.  The reference ``vmap``s the branchless cascade
over that axis; here the branchless cascade takes the axis directly.
:func:`route_to_instances` fans a global triple stream out to the K
instances by a key hash, so each key always lands on the same instance.

:class:`MultiStreamEngine` composes K instances a device with a device
mesh (:mod:`repro_torch.core.mesh`): D shards of K instances, K x D in
all, each shard stepped on its own device with no collective on the
update path, as the paper's deployment runs.
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch

from . import assoc, hierarchical
from . import mesh as mesh_mod
from .assoc import PAD, Assoc
from .hierarchical import HierAssoc, telescoped_caps
from .semiring import PLUS_TIMES, Semiring
from .telemetry import TelemetrySnapshot


def init_packed(
    n_instances: int,
    cuts: Sequence[int],
    top_capacity: int,
    batch_size: int,
    sr: Semiring = PLUS_TIMES,
    dtype=torch.float32,
    pad_pow2: bool = False,
    device=None,
) -> HierAssoc:
    """``n_instances`` independent empty hierarchies, stacked per leaf, on
    the card unless ``device="cpu"``; ``pad_pow2`` gives the power-of-two
    widths of the reference's Pallas engine (the port's engines need none)."""
    return hierarchical.init(
        cuts, top_capacity, batch_size, sr, dtype, device,
        batch=(int(n_instances),), pad_pow2=pad_pow2,
    )


def flat_layer_state(h: HierAssoc):
    """The packed buffers in the kernel's layout: per-layer
    ``(rows, cols, vals)`` (each ``[K, Q_i]``) plus ``[K, L]`` planes of nnz,
    cascade counters and overflow flags."""
    bufs = tuple((l.rows, l.cols, l.vals) for l in h.layers)
    nnz = torch.stack([l.nnz for l in h.layers], dim=1)
    overflow = torch.stack([l.overflow for l in h.layers], dim=1)
    return bufs, nnz, h.cascades, overflow


def from_flat_layer_state(bufs, nnz, cascades, overflow) -> HierAssoc:
    """Inverse of :func:`flat_layer_state`."""
    layers = tuple(
        Assoc(rows=r, cols=c, vals=v, nnz=nnz[:, i].contiguous(), overflow=overflow[:, i].contiguous())
        for i, (r, c, v) in enumerate(bufs)
    )
    return HierAssoc(layers=layers, cascades=cascades)


def instance(h: HierAssoc, k: int) -> HierAssoc:
    """Instance ``k`` of a packed hierarchy (views, no copies)."""
    return HierAssoc(
        layers=tuple(
            Assoc(l.rows[k], l.cols[k], l.vals[k], l.nnz[k], l.overflow[k])
            for l in h.layers
        ),
        cascades=h.cascades[k],
    )


def packed_update(
    h: HierAssoc,
    rows: torch.Tensor,  # [K, B] int32
    cols: torch.Tensor,
    vals: torch.Tensor,
    cuts: Sequence[int],
    sr: Semiring = PLUS_TIMES,
    branchless: bool | None = None,
) -> HierAssoc:
    """One streaming update on every packed instance at once: the
    branchless cascade over the ``[K]`` axis.  ``K = 1`` keeps the cond
    form unless ``branchless=True``, as in the reference."""
    cuts = tuple(int(c) for c in cuts)
    if rows.shape[0] == 1 and branchless is not True:
        h1 = hierarchical.update_triples(
            instance(h, 0), rows[0], cols[0], vals[0], cuts, sr
        )
        return HierAssoc(
            layers=tuple(
                Assoc(l.rows[None], l.cols[None], l.vals[None], l.nnz[None], l.overflow[None])
                for l in h1.layers
            ),
            cascades=h1.cascades[None],
        )
    return hierarchical.update_triples(h, rows, cols, vals, cuts, sr, branchless=True)


# ---------------------------------------------------------------------------
# packed telemetry / snapshots
# ---------------------------------------------------------------------------

def nnz_per_instance(h: HierAssoc) -> torch.Tensor:
    """Per-instance upper bound on distinct keys; ``[K]`` int32."""
    return hierarchical.nnz_total(h)


def nnz_total(h: HierAssoc) -> torch.Tensor:
    return nnz_per_instance(h).sum(dtype=torch.int32)


def cascades_per_instance(h: HierAssoc) -> torch.Tensor:
    """Per-instance cascade counters; ``[K, n_layers]`` int32."""
    return h.cascades


def overflowed_per_instance(h: HierAssoc) -> torch.Tensor:
    """Sticky per-instance overflow flags; ``[K]`` bool."""
    return hierarchical.overflowed(h)


def snapshot_packed(h: HierAssoc, cap: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Per-instance ``A = sum_i A_i``, stacked on a leading ``[K]`` axis.
    One instance at a time, so the merge temporaries stay one instance
    wide at full-size capacities."""
    snaps = [
        hierarchical.snapshot(instance(h, k), cap=cap, sr=sr)
        for k in range(h.cascades.shape[0])
    ]
    return Assoc(
        rows=torch.stack([s.rows for s in snaps]),
        cols=torch.stack([s.cols for s in snaps]),
        vals=torch.stack([s.vals for s in snaps]),
        nnz=torch.stack([s.nnz for s in snaps]),
        overflow=torch.stack([s.overflow for s in snaps]),
    )


def merge_snapshots(snap: Assoc, cap: int, sr: Semiring = PLUS_TIMES) -> Assoc:
    """Fold a ``[K]``-leading snapshot into one global Assoc by the
    reference's pairwise halving (pad K to a power of two with empties)."""
    k = snap.rows.shape[0]
    p = 1 << max(0, (k - 1)).bit_length()
    if p != k:
        fill = assoc.empty(
            snap.rows.shape[1], sr, snap.vals.dtype, snap.rows.device, (p - k,)
        )
        snap = Assoc(
            *(torch.cat([a, b], dim=0) for a, b in zip(
                (snap.rows, snap.cols, snap.vals, snap.nnz, snap.overflow),
                (fill.rows, fill.cols, fill.vals, fill.nnz, fill.overflow),
            ))
        )
    while p > 1:
        half = p // 2
        a = Assoc(snap.rows[:half], snap.cols[:half], snap.vals[:half], snap.nnz[:half], snap.overflow[:half])
        b = Assoc(snap.rows[half:], snap.cols[half:], snap.vals[half:], snap.nnz[half:], snap.overflow[half:])
        snap = assoc.add(a, b, cap=cap, sr=sr)
        p = half
    return Assoc(snap.rows[0], snap.cols[0], snap.vals[0], snap.nnz[0], snap.overflow[0])


# ---------------------------------------------------------------------------
# hash routing: one global triple stream -> K instance sub-streams
# ---------------------------------------------------------------------------

_H1 = 0x9E3779B1  # golden-ratio multiplicative constants
_H2 = 0x85EBCA77
_M1 = 0x7FEB352D  # murmur-style finalizer multipliers
_M2 = 0x846CA68B
_MASK = 0xFFFFFFFF

#: Width of the routing hash (see the reference's ``KEY_HASH_BITS``).
KEY_HASH_BITS = 32


def _mul32(x: torch.Tensor, h: int) -> torch.Tensor:
    """``(x * h) mod 2**32`` for ``0 <= x < 2**32`` in int64, split into
    16-bit halves of ``h`` so no int64 product overflows."""
    hi = ((x * (h >> 16)) & 0xFFFF) << 16
    return (hi + x * (h & 0xFFFF)) & _MASK


def key_hash32(rows: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """The finalized 32-bit key hash every routing tier reads, with uint32
    wraparound computed in int64.  Returns int64 values in ``[0, 2**32)``."""
    r = rows.to(torch.int64) & _MASK
    c = cols.to(torch.int64) & _MASK
    x = (_mul32(r, _H1) + _mul32(c, _H2)) & _MASK
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 15)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def instance_of(rows: torch.Tensor, cols: torch.Tensor, n_instances: int) -> torch.Tensor:
    """Which of ``n_instances`` owns key ``(row, col)``: the hash modulo K."""
    return (key_hash32(rows, cols) % int(n_instances)).to(torch.int32)


def scatter_to_slots(
    owner: torch.Tensor,
    live: torch.Tensor,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_slots: int,
    slot_cap: int,
    sr: Semiring = PLUS_TIMES,
):
    """Stable sort-scatter of a triple batch into ``[n_slots, slot_cap]``;
    triples beyond ``slot_cap`` in one slot are counted in ``dropped``."""
    owner = torch.where(live, owner, n_slots)  # park dead entries
    order = torch.sort(owner, stable=True).indices
    owner_s = owner[order].contiguous()
    idx = torch.arange(rows.shape[0], device=rows.device)
    rank = idx - torch.searchsorted(owner_s, owner_s)
    live_s = live[order]
    dropped = ((rank >= slot_cap) & live_s).sum(dtype=torch.int32)
    total = n_slots * slot_cap
    slot = torch.where((rank < slot_cap) & live_s, owner_s.to(torch.int64) * slot_cap + rank, total)

    def place(src, fill, dtype):
        out = torch.full((total + 1,), fill, dtype=dtype, device=rows.device)
        return out.scatter_(0, slot, src[order])[:total].reshape(n_slots, slot_cap)

    return (
        place(rows.to(torch.int32), PAD, torch.int32),
        place(cols.to(torch.int32), PAD, torch.int32),
        place(vals, sr.zero_as(vals.dtype), vals.dtype),
        dropped,
    )


def route_to_instances(
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    n_instances: int,
    slot_cap: int,
    sr: Semiring = PLUS_TIMES,
):
    """Split one global triple batch into per-instance sub-batches:
    ``(rows, cols, vals, dropped)`` with ``[n_instances, slot_cap]`` shapes."""
    owner = instance_of(rows, cols, n_instances)
    live = rows != PAD
    return scatter_to_slots(owner, live, rows, cols, vals, n_instances, slot_cap, sr)


# ---------------------------------------------------------------------------
# mesh composition: K instances a shard x D shards
# ---------------------------------------------------------------------------

def gather_packed(shards: Sequence[HierAssoc], device) -> HierAssoc:
    """One packed ``[K*D]`` hierarchy on ``device`` from D per-shard
    ``[K]`` hierarchies (instance-major: shard ``d`` holds instances
    ``d*K .. d*K+K-1``), as owned tensors."""
    device = torch.device(device)

    def cat(xs):
        return torch.cat([x.to(device) for x in xs])

    return HierAssoc(
        layers=tuple(
            Assoc(*(cat([getattr(h.layers[i], f) for h in shards])
                    for f in ("rows", "cols", "vals", "nnz", "overflow")))
            for i in range(len(shards[0].layers))
        ),
        cascades=cat([h.cascades for h in shards]),
    )


def split_packed(h: HierAssoc, mesh: "mesh_mod.Mesh", axes: Sequence[str] | None = None) -> Tuple[HierAssoc, ...]:
    """A packed ``[K*D]`` hierarchy split onto ``mesh`` by its leading
    axis (over ``axes``, all of the mesh's by default): one ``[K]``
    hierarchy a mesh device, each chunk copied straight to its device
    into buffers of its own (the whole state is never staged on one
    device)."""
    spec = mesh_mod.P(tuple(axes or mesh.axis_names))
    placed = mesh_mod.device_put(h, mesh_mod.NamedSharding(mesh, spec), copy=True)
    return mesh_mod.local_shards(placed, mesh.size)


class MultiStreamEngine:
    """K independent hierarchies a shard, composed over a device mesh.

    The state is one packed ``[K]`` :class:`HierAssoc` a mesh device (a
    tuple, in :attr:`Mesh.device_list` order), each on its device; the
    global instance axis is ``[K*D]`` instance-major over ``axis_names``.
    :meth:`update` steps each shard on its own device with no collective:
    the ``hier_cascade`` kernel behind the ``sort_dedup`` canonicalization
    on the card, their plain versions on the CPU, bit-identical to the
    reference's ``packed_update`` whatever ``branchless`` says.
    :meth:`global_nnz` is one counted ``all-reduce`` an axis, off the
    update path.  Shards of one device run in order on its current stream.
    On a mesh with axes beyond ``axis_names`` each shard is replicated over
    them, as the reference's ``P(axes)`` replicates it: every replica is
    stepped, and reads take the first.
    """

    def __init__(
        self,
        mesh: "mesh_mod.Mesh",
        cuts: Sequence[int],
        top_capacity: int,
        batch_size: int,
        instances_per_device: int = 1,
        sr: Semiring = PLUS_TIMES,
        axis_names: Tuple[str, ...] | None = None,
        dtype=torch.float32,
        branchless: bool | None = None,
    ):
        if instances_per_device < 1:
            raise ValueError(f"instances_per_device must be >= 1, got {instances_per_device}")
        from repro_torch.kernels.hier_cascade import ops as cascade_ops

        self._cascade_update = cascade_ops.cascade_update
        self.branchless = branchless
        self.mesh = mesh
        self.cuts = tuple(int(c) for c in cuts)
        self.sr = sr
        self.batch_size = int(batch_size)
        self.instances_per_device = int(instances_per_device)
        self.axes = tuple(axis_names or mesh.axis_names)
        self.n_devices = math.prod(mesh.shape[a] for a in self.axes)
        self.n_instances = self.n_devices * self.instances_per_device
        self.top_capacity = int(top_capacity)
        self.dtype = dtype
        self.caps = telescoped_caps(self.cuts, self.top_capacity, self.batch_size)
        self.sharding = mesh_mod.NamedSharding(mesh, mesh_mod.P(self.axes))
        chunks, _ = mesh.chunk_of(self.sharding.spec)
        #: mesh device index of the first replica of each chunk, in chunk order
        self.primary = [chunks.index(c) for c in range(self.n_devices)]

    # -- state & stream placement ------------------------------------------
    def init_state(self) -> Tuple[HierAssoc, ...]:
        """Empty packed hierarchies, one a mesh device, on its device."""
        return tuple(
            init_packed(self.instances_per_device, self.cuts, self.top_capacity,
                        self.batch_size, self.sr, self.dtype, device=dev)
            for dev in self.mesh.device_list
        )

    def shard_stream(self, rows, cols, vals):
        """Place pre-split ``[n_instances, B]`` triples instance-major:
        three :class:`~repro_torch.core.mesh.Sharded` values, each device
        holding its ``[K, B]`` block (a view where it already lies there)."""
        return tuple(
            x if isinstance(x, mesh_mod.Sharded) else mesh_mod.device_put(x, self.sharding)
            for x in (rows, cols, vals)
        )

    def primaries(self, h: Tuple[HierAssoc, ...]) -> Tuple[HierAssoc, ...]:
        """One state a chunk (the first replica), in instance order."""
        return tuple(h[i] for i in self.primary)

    # -- ingestion ----------------------------------------------------------
    def update(self, h: Tuple[HierAssoc, ...], rows, cols, vals) -> Tuple[HierAssoc, ...]:
        """One step of every shard on its own device: no collective.  The
        triples are :meth:`shard_stream`'s, or ``[n_instances, B]`` tensors
        placed here.  The previous state is consumed."""
        r, c, v = (x.shards for x in self.shard_stream(rows, cols, vals))
        return tuple(
            self._cascade_update(h[i], r[i], c[i], v[i], self.cuts, self.caps, self.sr)
            for i in range(self.mesh.size)
        )

    def route(self, rows, cols, vals):
        """Hash-split a flat global batch to all instances, on the mesh's
        first device, and place the sub-batches instance-major:
        ``(rows, cols, vals, dropped)``."""
        br, bc, bv, dropped = route_to_instances(
            rows, cols, vals, self.n_instances, self.batch_size, self.sr
        )
        return (*self.shard_stream(br, bc, bv), dropped)

    def ingest(self, h, rows, cols, vals):
        """Route one flat global batch and update every instance:
        ``(state, dropped)``."""
        br, bc, bv, dropped = self.route(rows, cols, vals)
        return self.update(h, br, bc, bv), dropped

    # -- analysis -----------------------------------------------------------
    def global_nnz(self, h) -> torch.Tensor:
        """Total nnz over every instance: one ``psum`` an axis."""
        local = [nnz_total(hi) for hi in h]
        for ax in self.axes:
            local = self.mesh.psum(local, ax)
        return local[0]

    def _gather(self, xs) -> torch.Tensor:
        dev = self.mesh.device_list[0]
        return torch.cat([x.to(dev) for x in xs])

    def nnz_per_instance(self, h) -> torch.Tensor:
        return self._gather([nnz_per_instance(hi) for hi in self.primaries(h)])

    def overflowed_per_instance(self, h) -> torch.Tensor:
        return self._gather([overflowed_per_instance(hi) for hi in self.primaries(h)])

    def cascades_per_instance(self, h) -> torch.Tensor:
        return self._gather([hi.cascades for hi in self.primaries(h)])

    def snapshot(self, h, cap: int) -> Assoc:
        """Per-instance snapshots, an ``[n_instances]``-leading Assoc on the
        mesh's first device: each shard's on its own device, then moved."""
        snaps = [snapshot_packed(hi, cap=int(cap), sr=self.sr) for hi in self.primaries(h)]
        return Assoc(*(self._gather([getattr(s, f) for s in snaps])
                       for f in ("rows", "cols", "vals", "nnz", "overflow")))

    def snapshot_global(self, h, cap: int) -> Assoc:
        """One global Assoc: the semiring sum of every instance snapshot."""
        return merge_snapshots(self.snapshot(h, cap), cap=int(cap), sr=self.sr)

    def telemetry(self, h) -> TelemetrySnapshot:
        """Packed counters for dashboards and benchmarks (host values)."""
        nnz = self.nnz_per_instance(h)
        return TelemetrySnapshot(
            engine="mesh",
            nnz_per_instance=nnz.cpu().numpy(),
            cascades_per_instance=self.cascades_per_instance(h).cpu().numpy(),
            overflowed_per_instance=np.asarray(self.overflowed_per_instance(h).cpu().numpy()),
            nnz_total=int(nnz.sum()),
            n_instances=self.n_instances,
            instances_per_device=self.instances_per_device,
        )
