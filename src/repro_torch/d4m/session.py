"""The D4M streaming session (port of ``repro.d4m.session``).

:class:`D4MStream` runs one of three engines, picked from its
:class:`~repro_torch.d4m.config.StreamConfig` and its device:

* ``single``: K=1, the cond cascade (:func:`hierarchical.update_triples`),
  whose canonicalization and merges run in the ``sort_dedup`` and
  ``merge_add`` kernels on the card (through :mod:`repro_torch.core.assoc`);
* ``packed``: K>1, the branchless cascade over the ``[K]`` axis
  (:func:`multistream.packed_update`), the choice on the CPU;
* ``cuda``: K>=1, the lane-skipping ``hier_cascade`` kernel
  (:mod:`repro_torch.kernels.hier_cascade`), the choice at K>1 on the card
  (the reference's ``pallas`` engine).

The session runs on the card unless it is given ``device="cpu"``.  The
engines update the state eagerly; ``update`` consumes the previous state
as the reference's donated step does (the ``cuda`` engine writes its layer
buffers in place).
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import analytics, assoc, hierarchical, multistream
from repro_torch.core.assoc import Assoc
from repro_torch.core.hierarchical import HierAssoc
from repro_torch.core.semiring import PLUS_TIMES, Semiring
from repro_torch.core.telemetry import TelemetrySnapshot
from repro_torch.device import resolve_device
from repro_torch.kernels.hier_cascade import ops as cascade_ops

from .config import CapacityPlan, StreamConfig


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

class QueryNamespace:
    """Bound analytics over the session's current snapshot, with capacity
    arguments filled from the session's :class:`CapacityPlan`."""

    def __init__(self, session: "D4MStream"):
        self._s = session

    def degrees(self, cap: int | None = None) -> Tuple[Assoc, Assoc]:
        """(out_degree, in_degree) keyed ``(vertex, 0)``, cached until the
        next update."""
        s = self._s
        cap = self._cap(cap)
        if cap not in s._degree_cache:
            s._degree_cache[cap] = analytics.degrees(s.snapshot(), cap=cap, sr=s.sr)
        return s._degree_cache[cap]

    def top_k(self, k: int = 10, by: str = "out") -> Tuple[torch.Tensor, torch.Tensor]:
        """Heaviest-k vertices by out/in degree: ``(ids [k], counts [k])``."""
        out_deg, in_deg = self.degrees()
        return analytics.top_k_vertices(out_deg if by == "out" else in_deg, k)

    def _cap(self, cap: int | None) -> int:
        return int(cap) if cap is not None else self._s.plan.snapshot_cap

    def triangles(self, cap_sq: int | None = None, max_fanout: int | None = None) -> torch.Tensor:
        """Triangle count of the undirected support (tr(A^3)/6), over the
        boolean support under plus.times whatever the session's semiring."""
        s = self._s
        und = analytics.undirected_view(s.snapshot(), cap=2 * s.plan.snapshot_cap, sr=PLUS_TIMES)
        return analytics.triangle_count(
            und,
            cap_sq=cap_sq if cap_sq is not None else 4 * s.plan.snapshot_cap,
            max_fanout=max_fanout if max_fanout is not None else s.plan.max_fanout,
        )

    def common_neighbors(self, u: int, v: int, cap: int | None = None) -> torch.Tensor:
        return analytics.common_neighbors(self._s.snapshot(), u, v, cap=self._cap(cap))

    def jaccard(self, u: int, v: int, cap: int | None = None) -> torch.Tensor:
        return analytics.jaccard(self._s.snapshot(), u, v, cap=self._cap(cap))

    def reachable_within(
        self, steps: int, cap: int | None = None, max_fanout: int | None = None
    ) -> Assoc:
        return analytics.reachable_within(
            self._s.snapshot(),
            steps,
            cap=self._cap(cap),
            max_fanout=max_fanout if max_fanout is not None else self._s.plan.max_fanout,
        )

    def row(self, r: int, cap: int | None = None) -> Assoc:
        """Row slice ``A(r, :)``."""
        s = self._s
        return assoc.extract_row(s.snapshot(), r, cap=self._cap(cap), sr=s.sr)

    def get(self, r, c) -> torch.Tensor:
        """Point query ``A(r, c)``."""
        return assoc.get(self._s.snapshot(), r, c, sr=self._s.sr)


# ---------------------------------------------------------------------------
# the session facade
# ---------------------------------------------------------------------------

class D4MStream:
    """One streaming D4M session over the engine the config and device
    call for (see the module docstring)."""

    def __init__(self, config: StreamConfig, *, device: str | torch.device | None = None):
        config.validate()
        self.device = resolve_device(device)
        self.config = config
        self.plan: CapacityPlan = config.plan()
        self.cuts = config.resolved_cuts()
        self.sr = config.sr
        self.dtype = config.torch_dtype
        self.batch_size = int(config.batch_size)
        self.k_per_device = int(config.instances_per_device)
        self.kind = config.resolved_engine(self.device)
        self.n_instances = 1 if self.kind == "single" else self.k_per_device
        self._snap_cache: Dict[Tuple[int, bool], Assoc] = {}
        self._degree_cache: Dict[int, Tuple[Assoc, Assoc]] = {}
        self._query: Optional[QueryNamespace] = None
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

    def _tensors(self, rows, cols, vals):
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
        return cascade_ops.cascade_update(
            h, rows, cols, vals, self.cuts, self.plan.layer_caps, self.sr
        )

    # -- write side ----------------------------------------------------------
    def update(self, rows, cols, vals) -> "D4MStream":
        """One pre-shaped batch: ``[B]`` (single) or ``[K, B]`` (packed,
        cuda).  The previous state is consumed."""
        self.state = self._step(self.state, *self._tensors(rows, cols, vals))
        self._invalidate()
        return self

    def route(self, rows, cols, vals):
        """Hash-split a flat global batch into per-instance sub-batches
        without updating: ``(rows, cols, vals, dropped)``."""
        rows, cols, vals = self._tensors(rows, cols, vals)
        if self.kind == "single":
            return rows, cols, vals, torch.zeros((), dtype=torch.int32, device=self.device)
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
        pre-routed.  Returns the per-step nnz trace."""
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
        self._snap_cache.clear()
        self._degree_cache.clear()

    def nnz(self) -> int:
        """Total distinct-key upper bound across all instances."""
        return int(hierarchical.nnz_total(self.state).sum())

    def overflowed(self) -> bool:
        """Sticky: any instance exceeded a static capacity somewhere."""
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

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return (
            f"D4MStream(engine={self.kind}, instances={self.n_instances}, "
            f"layers={self.plan.n_layers}, sr={self.sr.name}, device={self.device})"
        )
