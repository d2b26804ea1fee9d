"""The D4M streaming session (port of ``repro.d4m.session``).

:class:`D4MStream` runs one of four engines, picked from its
:class:`~repro_torch.d4m.config.StreamConfig` and its device:

* ``single``: K=1, the cond cascade (:func:`hierarchical.update_triples`),
  whose canonicalization and merges run in the ``sort_dedup`` and
  ``merge_add`` kernels on the card (through :mod:`repro_torch.core.assoc`);
* ``packed``: K>1, the branchless cascade over the ``[K]`` axis
  (:func:`multistream.packed_update`), the choice on the CPU;
* ``cuda``: K>=1, the lane-skipping ``hier_cascade`` kernel
  (:mod:`repro_torch.kernels.hier_cascade`), the choice at K>1 on the card
  (the reference's ``pallas`` engine);
* ``mesh``: D>1 shards of K instances over a device mesh
  (:class:`~repro_torch.core.multistream.MultiStreamEngine`), each shard
  stepped on its own device by the ``cuda`` engine's step (its plain
  version on the CPU) with no collective.  ``mesh=`` takes a
  :class:`~repro_torch.core.mesh.Mesh`, which may repeat a device
  (``Mesh([torch.device("cuda", 0)] * 4, ("data",))``: four shards on one
  card); ``devices=D`` alone builds one over the first D devices.

The session runs on the card unless it is given ``device="cpu"``.  The
engines update the state eagerly; ``update`` consumes the previous state
as the reference's donated step does (the ``cuda`` engine writes its layer
buffers in place).

The read side is the reference's query plane: :meth:`D4MStream.view`
materializes an owned, immutable :class:`StreamView` (a snapshot computed
into fresh tensors, with a CUDA event recorded behind it on the card), and
:attr:`D4MStream.query` answers over the latest published view while a
serve loop runs, else over a lazily built view of the live state.
Checkpoints (:meth:`D4MStream.checkpoint`, :meth:`D4MStream.restore`) use
the reference's on-disk format and leaf names, so either package restores
the other's.
"""
from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import analytics, assoc, hierarchical, multistream
from repro_torch.core import mesh as mesh_mod
from repro_torch.core.assoc import Assoc
from repro_torch.core.hierarchical import HierAssoc
from repro_torch.core.semiring import PLUS_TIMES, Semiring
from repro_torch.core.telemetry import TelemetrySnapshot
from repro_torch.device import resolve_device
from repro_torch.kernels.hier_cascade import ops as cascade_ops

from .config import CapacityPlan, ServeConfig, StreamConfig


# ---------------------------------------------------------------------------
# step builders (the reference's jit'd builders; eager here)
# ---------------------------------------------------------------------------

def build_update_step(
    cuts: Sequence[int], sr: Semiring = PLUS_TIMES, instances: int | None = None
):
    """A ``(h, rows, cols, vals) -> h`` single-batch update; with
    ``instances=K`` it updates a packed hierarchy from ``[K, B]`` batches."""
    cuts = tuple(int(c) for c in cuts)
    if instances is None:
        return lambda h, r, c, v: hierarchical.update_triples(h, r, c, v, cuts, sr)
    k = int(instances)

    def step(h: HierAssoc, rows, cols, vals) -> HierAssoc:
        if rows.shape[0] != k:
            raise ValueError(f"expected [{k}, B] instance-major triples, got {tuple(rows.shape)}")
        return multistream.packed_update(h, rows, cols, vals, cuts, sr)

    return step


def scan_ingest(
    h: HierAssoc,
    rows: torch.Tensor,  # [T, B], or [T, K, B] when instances=K
    cols: torch.Tensor,
    vals: torch.Tensor,
    cuts: Sequence[int],
    sr: Semiring = PLUS_TIMES,
    instances: int | None = None,
    branchless: bool | None = None,
) -> Tuple[HierAssoc, torch.Tensor]:
    """Ingest a stream of batches (a loop where the reference scans) and
    return the final state with the per-step nnz trace (``[T]`` or
    ``[T, K]``)."""
    cuts = tuple(int(c) for c in cuts)
    trace = []
    if instances is not None and (rows.ndim != 3 or rows.shape[1] != int(instances)):
        raise ValueError(
            f"expected [T, {int(instances)}, B] instance-major stream, got {tuple(rows.shape)}"
        )
    for t in range(rows.shape[0]):
        if instances is None:
            h = hierarchical.update_triples(
                h, rows[t], cols[t], vals[t], cuts, sr, branchless=bool(branchless)
            )
            trace.append(hierarchical.nnz_total(h))
        else:
            h = multistream.packed_update(h, rows[t], cols[t], vals[t], cuts, sr, branchless=branchless)
            trace.append(multistream.nnz_per_instance(h))
    return h, torch.stack(trace)


def scan_ingest_and_snapshot(
    h: HierAssoc,
    rows: torch.Tensor,
    cols: torch.Tensor,
    vals: torch.Tensor,
    cuts: Sequence[int],
    cap: int,
    sr: Semiring = PLUS_TIMES,
    instances: int | None = None,
):
    """Stream ingest followed by a full snapshot: ``(h, snapshot, trace)``.
    With ``instances=K`` the stream is ``[T, K, B]`` into a packed hierarchy
    and the snapshot is the global array (the semiring sum of the K
    per-instance snapshots)."""
    h2, trace = scan_ingest(h, rows, cols, vals, cuts, sr, instances=instances)
    if instances is None:
        snap = hierarchical.snapshot(h2, cap=cap, sr=sr)
    else:
        per = multistream.snapshot_packed(h2, cap=cap, sr=sr)
        snap = multistream.merge_snapshots(per, cap=cap, sr=sr)
    return h2, snap, trace


# ---------------------------------------------------------------------------
# the read side
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class StreamView:
    """One immutable, owned read view of a streaming session: the query
    plane's unit of snapshot isolation.

    ``snap`` holds fresh tensors computed by the snapshot (never the engine
    state the next update overwrites), so a view stays valid across any
    number of later updates, restores or resets.  On the card ``ready`` is a
    CUDA event recorded behind the snapshot's work on the publishing
    thread's stream; every query first makes its own stream wait for it
    (and, on another stream than the publisher's, marks the view's tensors
    as used there, so the allocator keeps them until that work is done).

    * ``seq``: publication sequence number (monotone per session);
    * ``records``: source records folded in, when the publisher knows it
      (the serve loop's ``records_fed``), else ``None``;
    * ``nnz`` / ``overflowed``: state counters at publication.

    Degree vectors are cached per capacity on first use, and pre-seeded by
    the serve loop's :class:`~repro_torch.serve.query.DegreeTracker`.
    """

    snap: Assoc
    sr: Semiring
    plan: CapacityPlan
    engine: str
    seq: int
    records: Optional[int] = None
    published_at: float = 0.0
    nnz: Optional[int] = None
    overflowed: Optional[bool] = None
    ready: Any = dataclasses.field(default=None, repr=False, compare=False)
    _stream: Any = dataclasses.field(default=None, repr=False, compare=False)
    _degree_cache: Dict[int, Tuple[Assoc, Assoc]] = dataclasses.field(
        default_factory=dict, repr=False, compare=False
    )

    def _cap(self, cap: int | None) -> int:
        return int(cap) if cap is not None else self.plan.snapshot_cap

    def _sync(self) -> Assoc:
        """The snapshot, ordered after its publication on this thread's
        stream."""
        if self.ready is not None:
            here = torch.cuda.current_stream(self.snap.rows.device)
            here.wait_event(self.ready)
            if here != self._stream:
                for t in (self.snap.rows, self.snap.cols, self.snap.vals,
                          self.snap.nnz, self.snap.overflow):
                    t.record_stream(here)
        return self.snap

    def degrees(self, cap: int | None = None) -> Tuple[Assoc, Assoc]:
        """(out_degree, in_degree) keyed ``(vertex, 0)``, folded with the
        view semiring's add; cached per capacity."""
        cap = self._cap(cap)
        if cap not in self._degree_cache:
            self._degree_cache[cap] = analytics.degrees(self._sync(), cap=cap, sr=self.sr)
        return self._degree_cache[cap]

    def top_k(self, k: int = 10, by: str = "out") -> Tuple[torch.Tensor, torch.Tensor]:
        """Heaviest-k vertices by out/in degree: ``(ids [k], counts [k])``."""
        out_deg, in_deg = self.degrees()
        return analytics.top_k_vertices(out_deg if by == "out" else in_deg, k)

    def triangles(self, cap_sq: int | None = None, max_fanout: int | None = None) -> torch.Tensor:
        """Triangle count of the undirected support (tr(A^3)/6), over the
        boolean support under plus.times whatever the view's semiring."""
        und = analytics.undirected_view(self._sync(), cap=2 * self.plan.snapshot_cap, sr=PLUS_TIMES)
        return analytics.triangle_count(
            und,
            cap_sq=cap_sq if cap_sq is not None else 4 * self.plan.snapshot_cap,
            max_fanout=max_fanout if max_fanout is not None else self.plan.max_fanout,
        )

    def common_neighbors(self, u: int, v: int, cap: int | None = None) -> torch.Tensor:
        return analytics.common_neighbors(self._sync(), u, v, cap=self._cap(cap))

    def jaccard(self, u: int, v: int, cap: int | None = None) -> torch.Tensor:
        return analytics.jaccard(self._sync(), u, v, cap=self._cap(cap))

    def reachable_within(
        self, steps: int, cap: int | None = None, max_fanout: int | None = None
    ) -> Assoc:
        return analytics.reachable_within(
            self._sync(),
            steps,
            cap=self._cap(cap),
            max_fanout=max_fanout if max_fanout is not None else self.plan.max_fanout,
        )

    def row(self, r: int, cap: int | None = None) -> Assoc:
        """Row slice ``A(r, :)``."""
        return assoc.extract_row(self._sync(), r, cap=self._cap(cap), sr=self.sr)

    def get(self, r, c) -> torch.Tensor:
        """Point query ``A(r, c)``."""
        return assoc.get(self._sync(), r, c, sr=self.sr)

    def stats(self) -> Dict[str, Any]:
        """Publication metadata as a JSON-ready dict (the ``stats`` wire op)."""
        return {
            "seq": int(self.seq),
            "records": None if self.records is None else int(self.records),
            "engine": self.engine,
            "nnz": None if self.nnz is None else int(self.nnz),
            "overflowed": None if self.overflowed is None else bool(self.overflowed),
            "published_at": float(self.published_at),
        }


class QueryNamespace:
    """Bound analytics over the session's current read view, with capacity
    arguments filled from the session's :class:`CapacityPlan`.

    While a serve loop runs, the namespace answers over the latest
    published view and never touches the state the feed loop updates.
    Outside a serve it answers over a lazily built view of the live state,
    cached until the next update.  Querying during a serve that publishes
    no views reads the live state with a ``DeprecationWarning``, as in the
    reference.
    """

    def __init__(self, session: "D4MStream"):
        self._s = session

    def _resolve(self) -> StreamView:
        s = self._s
        if s._serving:
            v = s.latest_view()
            if v is not None:
                return v
            warnings.warn(
                "querying live mutable session state during an active serve "
                "is deprecated (the read races the update path): set "
                "ServeConfig.publish_every to publish snapshot-isolated "
                "views and bind through D4MStream.view()/latest_view()",
                DeprecationWarning,
                stacklevel=3,
            )
        return s._current_view()

    def degrees(self, cap: int | None = None) -> Tuple[Assoc, Assoc]:
        """(out_degree, in_degree) keyed ``(vertex, 0)``."""
        return self._resolve().degrees(cap)

    def top_k(self, k: int = 10, by: str = "out") -> Tuple[torch.Tensor, torch.Tensor]:
        """Heaviest-k vertices by out/in degree: ``(ids [k], counts [k])``."""
        return self._resolve().top_k(k, by)

    def triangles(self, cap_sq: int | None = None, max_fanout: int | None = None) -> torch.Tensor:
        """Triangle count of the undirected support (see
        :meth:`StreamView.triangles`)."""
        return self._resolve().triangles(cap_sq, max_fanout)

    def common_neighbors(self, u: int, v: int, cap: int | None = None) -> torch.Tensor:
        return self._resolve().common_neighbors(u, v, cap)

    def jaccard(self, u: int, v: int, cap: int | None = None) -> torch.Tensor:
        return self._resolve().jaccard(u, v, cap)

    def reachable_within(
        self, steps: int, cap: int | None = None, max_fanout: int | None = None
    ) -> Assoc:
        return self._resolve().reachable_within(steps, cap, max_fanout)

    def row(self, r: int, cap: int | None = None) -> Assoc:
        """Row slice ``A(r, :)``."""
        return self._resolve().row(r, cap)

    def get(self, r, c) -> torch.Tensor:
        """Point query ``A(r, c)``."""
        return self._resolve().get(r, c)


# ---------------------------------------------------------------------------
# the session facade
# ---------------------------------------------------------------------------

class D4MStream:
    """One streaming D4M session over the engine the config and device
    call for (see the module docstring)."""

    def __init__(
        self,
        config: StreamConfig,
        *,
        device: str | torch.device | None = None,
        mesh: "mesh_mod.Mesh | None" = None,
        checkpoint_dir: str | None = None,
        checkpoint_keep: int = 3,
    ):
        config.validate()
        if mesh is not None:
            # an explicit mesh pins the device axis: fold it into the config
            # so plan() and telemetry report the true instance count
            first = mesh.device_list[0]
            if device is not None and torch.device(device) != first:
                raise ValueError(f"device={device!r} is not the mesh's first device {first}")
            config = dataclasses.replace(config, devices=mesh.size, engine="mesh")
            self.device = resolve_device(first)
        else:
            self.device = resolve_device(device)
            if config.devices is None:
                config = dataclasses.replace(config, devices=config.resolved_devices(self.device))
        self.config = config
        self.plan: CapacityPlan = config.plan()
        self.cuts = config.resolved_cuts()
        self.sr = config.sr
        self.dtype = config.torch_dtype
        self.batch_size = int(config.batch_size)
        self.k_per_device = int(config.instances_per_device)
        self.kind = config.resolved_engine(self.device)
        self.mesh = self.engine = None
        if self.kind == "mesh":
            # the first D devices of the session's kind; fewer raise ValueError
            self.mesh = mesh if mesh is not None else mesh_mod.Mesh.over(
                self.device.type, config.resolved_devices(self.device), config.axis_name)
            self.device = self.mesh.device_list[0]  # where routing and snapshots run
            self.engine = multistream.MultiStreamEngine(
                self.mesh, self.cuts, config.top_capacity, self.batch_size,
                instances_per_device=self.k_per_device, sr=self.sr, dtype=self.dtype,
                branchless=config.branchless,
            )
            self.n_instances = self.engine.n_instances
        else:
            self.n_instances = 1 if self.kind == "single" else self.k_per_device
        self._ckpt_dir = checkpoint_dir
        self._ckpt_keep = checkpoint_keep
        self._mgr = None
        self._snap_cache: Dict[Tuple[int, bool], Assoc] = {}
        self._query: Optional[QueryNamespace] = None
        # the query plane: published immutable views + the library-mode live
        # view (dropped on every mutation)
        self._view_seq = 0
        self._published_view: Optional[StreamView] = None
        self._live_view: Optional[StreamView] = None
        self._serving = False  # set by D4MServer while its feed loop owns state
        self._obs = None  # view-build histogram handle, set by D4MServer
        self._state: Optional[HierAssoc] = None  # allocated lazily

    # -- lifecycle -----------------------------------------------------------
    @property
    def state(self) -> HierAssoc:
        """The live hierarchy (allocated on first touch)."""
        if self._state is None:
            self._state = self._init_state()
        return self._state

    @state.setter
    def state(self, value: HierAssoc) -> None:
        self._state = value

    def _init_state(self) -> HierAssoc:
        if self.kind == "mesh":
            return self.engine.init_state()
        kw = dict(
            top_capacity=self.config.top_capacity,
            batch_size=self.batch_size,
            sr=self.sr,
            dtype=self.dtype,
            device=self.device,
        )
        if self.kind == "single":
            return hierarchical.init(self.cuts, **kw)
        return multistream.init_packed(self.n_instances, self.cuts, **kw)

    @classmethod
    def from_dict(cls, config: Dict[str, Any], **kwargs) -> "D4MStream":
        """Build a session from the :meth:`StreamConfig.to_dict` wire form
        of either package."""
        return cls(StreamConfig.from_dict(config), **kwargs)

    def reset(self) -> "D4MStream":
        """Fresh empty state."""
        self.state = self._init_state()
        self._invalidate()
        return self

    @property
    def raw_update(self):
        """The ``(h, rows, cols, vals) -> h`` update step of this session's
        engine, on tensors already on the session's device: the previous
        state is consumed, as the reference's donating step consumes it.
        Eager, so unlike the reference's jitted step it has no ``.lower()``
        to inspect."""
        return self._step

    def _tensors(self, rows, cols, vals):
        if isinstance(rows, mesh_mod.Sharded):  # placed by shard_stream
            return rows, cols, vals
        dev = self.device
        return (
            torch.as_tensor(rows, device=dev).to(torch.int32),
            torch.as_tensor(cols, device=dev).to(torch.int32),
            torch.as_tensor(vals, device=dev).to(self.dtype),
        )

    def _step(self, h: HierAssoc, rows, cols, vals) -> HierAssoc:
        if self.kind == "single":
            return hierarchical.update_triples(
                h, rows, cols, vals, self.cuts, self.sr,
                branchless=bool(self.config.branchless),
            )
        if self.kind == "packed":
            return multistream.packed_update(
                h, rows, cols, vals, self.cuts, self.sr, branchless=self.config.branchless
            )
        if self.kind == "mesh":
            return self.engine.update(h, rows, cols, vals)
        return cascade_ops.cascade_update(
            h, rows, cols, vals, self.cuts, self.plan.layer_caps, self.sr
        )

    # -- write side ----------------------------------------------------------
    def update(self, rows, cols, vals) -> "D4MStream":
        """One pre-shaped batch: ``[B]`` (single), ``[K, B]`` (packed,
        cuda) or ``[K*D, B]`` instance-major (mesh; or
        :meth:`shard_stream`'s placement).  The previous state is consumed."""
        self.state = self._step(self.state, *self._tensors(rows, cols, vals))
        self._invalidate()
        return self

    def shard_stream(self, rows, cols, vals):
        """Place pre-split ``[n_instances, B]`` triples instance-major (mesh
        engine: each shard's ``[K, B]`` block on its device; the identity
        elsewhere)."""
        if self.kind == "mesh":
            return self.engine.shard_stream(*self._tensors(rows, cols, vals))
        return rows, cols, vals

    def route(self, rows, cols, vals):
        """Hash-split a flat global batch into per-instance sub-batches
        without updating: ``(rows, cols, vals, dropped)``."""
        rows, cols, vals = self._tensors(rows, cols, vals)
        if self.kind == "single":
            return rows, cols, vals, torch.zeros((), dtype=torch.int32, device=self.device)
        if self.kind == "mesh":
            return self.engine.route(rows, cols, vals)
        return multistream.route_to_instances(
            rows, cols, vals, self.n_instances, self.batch_size, self.sr
        )

    def ingest(self, rows, cols, vals) -> torch.Tensor:
        """One flat global batch ``[B]``: hash-route to every instance, then
        update.  Returns the dropped-triple count (0 for ``single``)."""
        br, bc, bv, dropped = self.route(rows, cols, vals)
        self.update(br, bc, bv)
        return dropped

    def ingest_stream(self, rows, cols, vals) -> torch.Tensor:
        """Ingest a whole stream: ``[T, B]`` (single) or ``[T, K, B]``
        pre-routed.  Returns the per-step nnz trace.  Not offered on the
        mesh engine, as in the reference: loop over :meth:`update`."""
        if self.kind == "mesh":
            raise NotImplementedError(
                "ingest_stream is not available on the mesh engine; loop "
                "over update() so every step runs the verified shard_map "
                "program"
            )
        rows, cols, vals = self._tensors(rows, cols, vals)
        if self.kind != "single" and (rows.ndim != 3 or rows.shape[1] != self.n_instances):
            raise ValueError(
                f"expected [T, {self.n_instances}, B] instance-major stream, "
                f"got {tuple(rows.shape)}"
            )
        trace = []
        for t in range(rows.shape[0]):
            self.state = self._step(self.state, rows[t], cols[t], vals[t])
            trace.append(
                hierarchical.nnz_total(self.state)
                if self.kind == "single"
                else multistream.nnz_per_instance(self.state)
            )
        self._invalidate()
        return torch.stack(trace)

    # -- read side -----------------------------------------------------------
    def snapshot(self, cap: int | None = None, per_instance: bool = False) -> Assoc:
        """Materialize ``A = sum_i A_i``: global by default (the semiring sum
        of every instance's snapshot), ``[K]``-leading with
        ``per_instance=True``.  ``cap`` defaults to the plan's
        ``snapshot_cap``."""
        cap = int(cap) if cap is not None else self.plan.snapshot_cap
        key = (cap, per_instance)
        if key in self._snap_cache:
            return self._snap_cache[key]
        if self.kind == "single":
            if per_instance:
                raise ValueError("single-instance session has no per-instance axis")
            snap = hierarchical.snapshot(self.state, cap=cap, sr=self.sr)
        elif self.kind == "mesh":
            snap = (self.engine.snapshot(self.state, cap) if per_instance
                    else self.engine.snapshot_global(self.state, cap))
        else:
            snap = multistream.snapshot_packed(self.state, cap=cap, sr=self.sr)
            if not per_instance:
                snap = multistream.merge_snapshots(snap, cap=cap, sr=self.sr)
        if not per_instance and bool(snap.overflow) and not self.overflowed():
            import warnings

            warnings.warn(
                f"snapshot(cap={cap}) truncated the merged array "
                f"(overflow flag set); raise snapshot_cap in StreamConfig "
                f"or pass cap= explicitly",
                RuntimeWarning,
                stacklevel=2,
            )
        self._snap_cache[key] = snap
        return snap

    def _invalidate(self) -> None:
        """Every mutation lands here: drop the cached snapshots and the
        library-mode live view.  Published views stay: they are owned and
        answer until the next publication replaces them."""
        self._snap_cache.clear()
        self._live_view = None

    def synchronize(self) -> None:
        """Wait until every update queued on this thread's stream of the
        session's device has run (nothing to wait for on the CPU)."""
        devices = self.mesh.device_list if self.mesh is not None else [self.device]
        for dev in dict.fromkeys(devices):
            if dev.type == "cuda":
                torch.cuda.current_stream(dev).synchronize()

    def view(
        self,
        cap: int | None = None,
        *,
        records: int | None = None,
        degrees: Tuple[Assoc, Assoc] | None = None,
        publish: bool = True,
    ) -> StreamView:
        """Materialize an owned, immutable :class:`StreamView` of the
        current state.

        ``publish=True`` assigns the next sequence number and makes the view
        the session's :meth:`latest_view` (what the serve loop does at
        microbatch boundaries).  ``records`` stamps the source records
        folded in; ``degrees`` pre-seeds the view's degree cache.
        """
        seq = self._view_seq + 1 if publish else self._view_seq
        _t0 = 0 if self._obs is None else time.perf_counter_ns()
        snap = self.snapshot(cap)
        ready = stream = None
        if self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            ready = torch.cuda.Event()
            ready.record(stream)
        v = StreamView(
            snap=snap,
            sr=self.sr,
            plan=self.plan,
            engine=self.kind,
            seq=seq,
            records=None if records is None else int(records),
            published_at=time.monotonic(),
            nnz=self.nnz(),
            overflowed=self.overflowed(),
            ready=ready,
            _stream=stream,
        )
        if self._obs is not None:
            self._obs.record(time.perf_counter_ns() - _t0)
        if degrees is not None:
            v._degree_cache[v._cap(cap)] = degrees
        if publish:
            self._view_seq = seq
            self._published_view = v
        return v

    def latest_view(self) -> Optional[StreamView]:
        """The most recently published view (``None`` before the first);
        safe to read from any thread (publication swaps one reference)."""
        return self._published_view

    def _current_view(self) -> StreamView:
        """Library-mode read view: built lazily over the cached live
        snapshot, dropped by the next mutation (not published)."""
        if self._live_view is None:
            self._live_view = self.view(publish=False)
        return self._live_view

    def nnz(self) -> int:
        """Total distinct-key upper bound across all instances."""
        if self.kind == "mesh":
            return int(self.engine.global_nnz(self.state))
        return int(hierarchical.nnz_total(self.state).sum())

    def overflowed(self) -> bool:
        """Sticky: any instance exceeded a static capacity somewhere."""
        if self.kind == "mesh":
            return bool(self.engine.overflowed_per_instance(self.state).any())
        return bool(hierarchical.overflowed(self.state).any())

    def telemetry(self) -> TelemetrySnapshot:
        """Typed counters, as the reference's session reports them."""
        snap = TelemetrySnapshot(
            engine=self.kind,
            n_instances=self.n_instances,
            instances_per_device=self.k_per_device,
            nnz_total=self.nnz(),
            overflowed=self.overflowed(),
            state_bytes=self.plan.total_bytes,
        )
        h = self.state
        if self.kind == "single":
            snap.nnz_per_layer = [int(l.nnz) for l in h.layers]
            snap.cascades = h.cascades.cpu().numpy()
        elif self.kind == "mesh":
            snap.nnz_per_instance = self.engine.nnz_per_instance(h).cpu().numpy()
            snap.cascades_per_instance = self.engine.cascades_per_instance(h).cpu().numpy()
            snap.overflowed_per_instance = self.engine.overflowed_per_instance(h).cpu().numpy()
        else:
            snap.nnz_per_instance = multistream.nnz_per_instance(h).cpu().numpy()
            snap.cascades_per_instance = h.cascades.cpu().numpy()
            snap.overflowed_per_instance = np.asarray(
                multistream.overflowed_per_instance(h).cpu().numpy()
            )
        return snap

    @property
    def query(self) -> QueryNamespace:
        if self._query is None:
            self._query = QueryNamespace(self)
        return self._query

    # -- serving (wires repro_torch.serve) ----------------------------------
    def serve(
        self,
        source,
        serve_config: ServeConfig | None = None,
        timeout: float | None = None,
        **overrides,
    ):
        """Serve a record source into this session until it drains; returns
        a :class:`repro_torch.serve.ServeReport`.

        The explicit ``serve_config`` wins, then the config's ``serve=``
        field, then defaults; keyword ``overrides`` patch single fields.
        For manual control (live telemetry, a stop mid-stream) build a
        :class:`repro_torch.serve.D4MServer` directly.
        """
        from repro_torch.serve import D4MServer

        cfg = serve_config or self.config.serve or ServeConfig()
        if overrides:
            cfg = dataclasses.replace(cfg, **overrides)
        return D4MServer(self, source, cfg).run(timeout=timeout)

    # -- fault tolerance (wires repro_torch.checkpoint) -----------------------
    def _manager(self):
        if self._ckpt_dir is None:
            raise ValueError("session has no checkpoint_dir; pass checkpoint_dir= to D4MStream")
        if self._mgr is None:
            from repro_torch.checkpoint.manager import CheckpointManager

            self._mgr = CheckpointManager(self._ckpt_dir, keep=self._ckpt_keep)
        return self._mgr

    def checkpoint(self, step: int, extra: Dict[str, Any] | None = None) -> None:
        """Asynchronous atomic save of the whole state (plus metadata such
        as the stream cursor in ``extra``).  Host copies are taken before
        this returns, behind every update queued on this thread's stream;
        serialization overlaps the next updates.  The ``cuda`` engine writes
        its layers at the reference's power-of-two widths (the tail dead),
        so the reference's ``pallas`` engine restores it.  The ``mesh``
        engine writes the reference's mesh leaves: one ``[K*D]`` packed
        hierarchy at the true capacities, gathered from the shards' host
        copies."""
        state = self.state
        if self.kind == "cuda":
            state = hierarchical.pad_layers_pow2(state, self.sr)
        elif self.kind == "mesh":
            state = multistream.gather_packed(self.engine.primaries(state), "cpu")
        self._manager().save_async(step, state, extra=extra)

    def wait_checkpoint(self) -> None:
        self._manager().wait()

    def restore(self, step: int | None = None, fallback: bool | None = None) -> Dict[str, Any]:
        """Restore the state from the latest (or given) checkpoint, of either
        package; returns the saved ``extra`` metadata (e.g. the stream
        cursor).  ``fallback`` (default: on when no step is pinned) walks
        back past damaged generations to the newest one that verifies.

        A layer saved wider than this session's (the reference's ``pallas``
        engine and the port's ``cuda`` engine pad to powers of two) must be
        dead past this session's capacity, and is cut to it; a narrower one
        is padded with dead slots.  The state comes back as owned tensors
        on the session's device (through ``core.convert.hier_from_numpy``);
        on the mesh each shard's slice goes from the host copy straight to
        its own device, never staging the whole state on one.
        """
        from repro_torch.core import convert

        mgr = self._manager()
        mgr.wait()
        like = self.state
        if self.kind == "mesh":
            like = self.engine.primaries(like)[0]  # the leaves' names; [K*D] on disk
        host, extra = mgr.restore(like, step=step, fallback=fallback)
        layers = []
        for i, (l, want) in enumerate(zip(host.layers, like.layers)):
            width = want.capacity
            r, c, v = l.rows, l.cols, l.vals
            have = r.shape[-1]
            if have > width:
                if not (r[..., width:] == assoc.PAD).all():
                    raise ValueError(
                        f"checkpoint layer {i} holds live entries past this "
                        f"session's capacity {width}"
                    )
                r, c, v = r[..., :width], c[..., :width], v[..., :width]
            layers.append((r, c, v, l.nnz, l.overflow))
        on_mesh = self.kind == "mesh"
        h = convert.hier_from_numpy(layers, host.cascades, device="cpu" if on_mesh else self.device)
        zero = self.sr.zero_as(self.dtype)
        out = tuple(
            Assoc(
                rows=hierarchical.pad_tail(l.rows, want.capacity, assoc.PAD),
                cols=hierarchical.pad_tail(l.cols, want.capacity, assoc.PAD),
                vals=hierarchical.pad_tail(l.vals.to(self.dtype), want.capacity, zero),
                nnz=l.nnz,
                overflow=l.overflow,
            )
            for l, want in zip(h.layers, like.layers)
        )
        state = HierAssoc(layers=out, cascades=h.cascades)
        if on_mesh:
            state = multistream.split_packed(state, self.mesh, self.engine.axes)
        self.state = state
        self._invalidate()
        return extra

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"D4MStream(engine={self.kind}, instances={self.n_instances}, "
            f"layers={self.plan.n_layers}, sr={self.sr.name}, device={self.device})"
        )
