"""One typed telemetry record for every layer of the stack (a copy of
``repro.core.telemetry``, with the same ``schema_version``, so
:meth:`TelemetrySnapshot.merge` accepts snapshots from both packages).

Before this module, three ad-hoc dicts described the system's counters:
``D4MStream.telemetry()`` (per-session device counters),
``MultiStreamEngine.telemetry()`` (packed per-instance counters) and
``D4MServer.telemetry()`` (serve-loop host counters).  Benchmarks and tests
re-plucked string keys from each.  :class:`TelemetrySnapshot` unifies them:
one dataclass, engine fields + serve fields, where every producer fills the
fields it owns and leaves the rest ``None``.

Compatibility: the snapshot implements the read-only mapping protocol over
its *set* fields (``tel["nnz_total"]``, ``"drained" in tel``, ``dict(tel)``
all behave exactly like the old dicts), so existing call sites keep
working; ``None`` fields simply don't exist as keys, mirroring how each old
dict only carried its own counters.  New code should use attributes —
``tel.nnz_total`` — and benchmarks consume :meth:`serve_counters` /
:meth:`to_json` instead of re-plucking keys.

Lives in ``repro_torch.core`` so every layer can import it without
cycles.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, List, Optional

import numpy as np

#: Version of the counter schema.  Bumped when a counter changes meaning
#: (not when a new optional field appears); :meth:`TelemetrySnapshot.merge`
#: refuses to sum snapshots across versions, so a fleet of mixed-version
#: workers fails loudly instead of producing silently-wrong aggregates.
TELEMETRY_SCHEMA_VERSION = 1

#: Counter fields :meth:`TelemetrySnapshot.merge` sums across snapshots.
#: Everything here is an additive count: totals over a fleet are the sum
#: of the per-worker values.
_MERGE_SUM_FIELDS = (
    "nnz_total",
    "state_bytes",
    "records_in",
    "records_fed",
    "batches_fed",
    "records_dropped",
    "routing_dropped",
    "blocked_events",
    "queue_depth",
    "pending",
    "malformed",
    "source_records",
    "n_instances",
    # query-plane counters: additive across a fleet like the rest
    "views_published",
    "queries_served",
)


def _jsonable(value: Any) -> Any:
    if isinstance(value, TelemetrySnapshot):
        return value.to_json()
    if isinstance(value, np.ndarray):
        return value.tolist()
    if isinstance(value, np.generic):
        return value.item()
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    return value


def _merge_state_maps(maps) -> Dict[str, Dict[str, Any]]:
    """Bucket-wise sum (and max of max) of ``{name: {"counts", "max_ns"}}``
    histogram states: the reference's ``merge_state_maps``."""
    out: Dict[str, Dict[str, Any]] = {}
    for m in maps:
        for name, st in m.items():
            counts = [int(c) for c in st["counts"]]
            max_ns = int(st.get("max_ns", 0))
            if name in out:
                if len(out[name]["counts"]) != len(counts):
                    raise ValueError(
                        f"cannot merge histograms with {len(out[name]['counts'])} "
                        f"vs {len(counts)} buckets"
                    )
                counts = [a + b for a, b in zip(out[name]["counts"], counts)]
                max_ns = max(max_ns, out[name]["max_ns"])
            out[name] = {"counts": counts, "max_ns": max_ns}
    return out


@dataclasses.dataclass(eq=False)
class TelemetrySnapshot:
    """Counters of one engine/session/serve-loop observation.

    Field groups (each producer sets its own, leaves the rest ``None``):

    * **identity** — ``engine``, ``n_instances``, ``instances_per_device``;
    * **state counters** (device side, quiescent) — ``nnz_total``,
      ``overflowed``, ``state_bytes``, plus the single-instance per-layer
      views (``nnz_per_layer``, ``cascades``) or the packed per-instance
      views (``nnz_per_instance``, ``cascades_per_instance``,
      ``overflowed_per_instance``);
    * **serve counters** (host side, live) — ``records_in`` /
      ``records_fed`` / ``records_dropped`` and friends, with the exact
      conservation contract ``records_in == records_fed + records_dropped``
      after drain/abort;
    * ``session`` — the nested state snapshot a :class:`ServeReport`
      carries once the feed loop is quiescent;
    * ``extras`` — escape hatch for producer-specific values.
    """

    # counter-schema version (see TELEMETRY_SCHEMA_VERSION); merge() refuses
    # to sum across versions
    schema_version: int = TELEMETRY_SCHEMA_VERSION
    # identity
    engine: Optional[str] = None
    n_instances: Optional[int] = None
    instances_per_device: Optional[int] = None
    # state counters (single-instance per-layer or packed per-instance)
    nnz_total: Optional[int] = None
    overflowed: Optional[bool] = None
    state_bytes: Optional[int] = None
    nnz_per_layer: Optional[List[int]] = None
    cascades: Optional[Any] = None
    nnz_per_instance: Optional[Any] = None
    cascades_per_instance: Optional[Any] = None
    overflowed_per_instance: Optional[Any] = None
    # serve-loop host counters
    records_in: Optional[int] = None
    records_fed: Optional[int] = None
    batches_fed: Optional[int] = None
    records_dropped: Optional[int] = None
    routing_dropped: Optional[int] = None
    blocked_events: Optional[int] = None
    queue_depth: Optional[int] = None
    pending: Optional[int] = None
    malformed: Optional[int] = None
    source_records: Optional[int] = None
    wall_s: Optional[float] = None
    ingest_rate: Optional[float] = None
    checkpoints: Optional[List[Dict[str, int]]] = None
    drained: Optional[bool] = None
    # query-plane counters (serve loop, host side).  view_staleness_records
    # is the staleness contract's number: source records the live head has
    # folded beyond the latest published view (0 right after a publish,
    # grows until the next boundary; None when publication is off).
    views_published: Optional[int] = None
    queries_served: Optional[int] = None
    view_seq: Optional[int] = None
    view_staleness_records: Optional[int] = None
    # runtime-observability latency distributions: a map of
    # histogram name -> {"counts": [...], "max_ns": int} bucket states.
    # None unless the producer ran with metrics enabled; merge() folds
    # them bucket-wise, so count conservation extends to distributions.
    histograms: Optional[Dict[str, Any]] = None
    # nested state snapshot (ServeReport.telemetry["session"])
    session: Optional["TelemetrySnapshot"] = None
    # producer-specific extension point
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # -- mapping-protocol shim (read side of the legacy dicts) ---------------
    def _set_fields(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for f in dataclasses.fields(self):
            if f.name == "extras":
                continue
            v = getattr(self, f.name)
            if v is not None:
                out[f.name] = v
        out.update(self.extras)
        return out

    def __getitem__(self, key: str) -> Any:
        fields = self._set_fields()
        if key not in fields:
            raise KeyError(key)
        return fields[key]

    def __contains__(self, key: object) -> bool:
        return key in self._set_fields()

    def __iter__(self) -> Iterator[str]:
        return iter(self._set_fields())

    def __len__(self) -> int:
        return len(self._set_fields())

    def keys(self):
        return self._set_fields().keys()

    def values(self):
        return self._set_fields().values()

    def items(self):
        return self._set_fields().items()

    def get(self, key: str, default: Any = None) -> Any:
        return self._set_fields().get(key, default)

    # -- aggregation ---------------------------------------------------------
    @classmethod
    def merge(cls, snapshots) -> "TelemetrySnapshot":
        """Sum counter fields across ``snapshots`` into one fleet-wide view.

        Additive counters (:data:`_MERGE_SUM_FIELDS`) are summed over the
        snapshots that set them; ``wall_s`` is the max (workers run
        concurrently), ``ingest_rate`` is recomputed as total fed over that
        wall, ``drained`` is the conjunction and ``overflowed`` the
        disjunction.  ``engine`` survives only if uniform.  Non-additive
        per-worker detail (checkpoints, per-instance arrays, extras) is
        deliberately not merged — read it from the individual snapshots.

        Raises ``ValueError`` on an empty iterable or on mixed
        ``schema_version`` values: a fleet of mixed-version workers must
        fail loudly, not produce silently-wrong sums.
        """
        snaps = list(snapshots)
        if not snaps:
            raise ValueError("merge() needs at least one snapshot")
        versions = {int(s.schema_version) for s in snaps}
        if len(versions) != 1:
            raise ValueError(
                f"cannot merge snapshots with mixed schema_version "
                f"{sorted(versions)}; counters may not be comparable"
            )
        out = cls(schema_version=versions.pop())
        engines = {s.engine for s in snaps if s.engine is not None}
        if len(engines) == 1:
            out.engine = engines.pop()
        for name in _MERGE_SUM_FIELDS:
            vals = [getattr(s, name) for s in snaps if getattr(s, name) is not None]
            if vals:
                setattr(out, name, sum(int(v) for v in vals))
        walls = [s.wall_s for s in snaps if s.wall_s is not None]
        if walls:
            out.wall_s = float(max(walls))
            if out.records_fed is not None and out.wall_s > 0:
                out.ingest_rate = out.records_fed / out.wall_s
        drained = [s.drained for s in snaps if s.drained is not None]
        if drained:
            out.drained = all(drained)
        overflowed = [s.overflowed for s in snaps if s.overflowed is not None]
        if overflowed:
            out.overflowed = any(overflowed)
        hist_maps = [s.histograms for s in snaps if s.histograms]
        if hist_maps:
            out.histograms = _merge_state_maps(hist_maps)
        return out

    # -- consumers -----------------------------------------------------------
    def serve_counters(self) -> Dict[str, int]:
        """The scalar serve-loop counters, ready to splat into a benchmark
        measurement (``report.add(..., **tel.serve_counters())``)."""
        out: Dict[str, int] = {}
        for name in (
            "records_in",
            "records_fed",
            "batches_fed",
            "records_dropped",
            "blocked_events",
            "malformed",
        ):
            v = getattr(self, name)
            if v is not None:
                out[name] = int(v)
        return out

    def to_json(self) -> Dict[str, Any]:
        """Plain JSON-ready dict (arrays -> lists, nested snapshots
        recursed) — what the bench layer records."""
        return {k: _jsonable(v) for k, v in self._set_fields().items()}
