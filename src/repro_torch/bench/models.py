"""Validated measurement models for the perf-observability plane (a copy
of ``repro.bench.models``: the port writes and reads the reference's schema).

The repo's measurement chain (tt-github-actions' ``collect_data`` shape,
SNIPPETS.md §1–2) is three layers, each a schema-versioned dataclass with a
``validate()`` that raises :class:`ModelError` on anything malformed —
garbage in a CI artifact must fail loudly at parse time, never corrupt the
committed history:

* :class:`Measurement` — one ``measurements[]`` entry of a
  ``BENCH_<section>.json`` payload (name + params key, optional
  ``updates_per_sec`` / ``wall_s`` / ``passed`` verdict, free-form extras);
* :class:`SectionRun` — one whole ``BENCH_<section>.json`` file: the
  section's measurements plus git/host provenance
  (``repro_torch/bench/reporting.py`` schema, the reference's, ``SCHEMA_VERSION = 1``);
* :class:`RunRecord` — one *normalized CI run*: every section artifact from
  every matrix leg swept into a single flat record
  (:func:`repro_torch.bench.parsers.normalize_run`), the unit appended to
  ``src/repro_torch/benchmarks/history/perf_history.jsonl`` and consumed by the trend gate
  and the report generator.

Measurements are keyed by ``(section, leg, name, params)`` — the same
identity the legacy artifact-diff gate used (section + name + params), plus
the CI matrix leg (``d1``/``d8`` forced-device legs re-run the same sections
with identical params, so the leg axis keeps their trajectories separate).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Mapping, Optional, Tuple

#: Schema of one ``BENCH_<section>.json`` payload (repro_torch/bench/reporting.py, the reference's schema).
SECTION_SCHEMA_VERSION = 1

#: Schema of one normalized run record (perf_history.jsonl lines).
HISTORY_SCHEMA_VERSION = 1


class ModelError(ValueError):
    """A payload does not conform to the measurement schema."""


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ModelError(msg)


def _jsonable(value: Any) -> Any:
    """Coerce numpy scalars/arrays into plain JSON values (history lines
    must round-trip through ``json`` bit-exactly)."""
    if hasattr(value, "tolist"):  # numpy array or scalar
        return value.tolist()
    if isinstance(value, dict):
        return {str(k): _jsonable(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_jsonable(v) for v in value]
    if isinstance(value, (str, int, float, bool)) or value is None:
        return value
    return repr(value)


def params_key(params: Mapping[str, Any]) -> Tuple[Tuple[str, str], ...]:
    """Canonical hashable identity of a params mapping (order-free)."""
    return tuple(sorted((str(k), repr(v)) for k, v in (params or {}).items()))


@dataclasses.dataclass
class Measurement:
    """One measurement of one section run.

    ``name`` + ``params`` identify the measurement across runs;
    ``updates_per_sec`` is the rate the trend gate tracks, ``passed`` the
    boolean verdict it guards, ``extras`` everything else the bench chose
    to record (speedups, byte counts, per-K rate maps, ...).
    """

    name: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    updates_per_sec: Optional[float] = None
    wall_s: Optional[float] = None
    passed: Optional[bool] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> "Measurement":
        _require(
            isinstance(self.name, str) and bool(self.name),
            f"measurement name must be a non-empty string, got {self.name!r}",
        )
        _require(
            isinstance(self.params, dict),
            f"measurement {self.name!r}: params must be a mapping, "
            f"got {type(self.params).__name__}",
        )
        if self.updates_per_sec is not None:
            _require(
                isinstance(self.updates_per_sec, (int, float))
                and not isinstance(self.updates_per_sec, bool)
                and self.updates_per_sec >= 0,
                f"measurement {self.name!r}: updates_per_sec must be a "
                f"non-negative number, got {self.updates_per_sec!r}",
            )
        if self.wall_s is not None:
            _require(
                isinstance(self.wall_s, (int, float))
                and not isinstance(self.wall_s, bool)
                and self.wall_s >= 0,
                f"measurement {self.name!r}: wall_s must be a non-negative "
                f"number, got {self.wall_s!r}",
            )
        if self.passed is not None:
            _require(
                isinstance(self.passed, bool),
                f"measurement {self.name!r}: passed must be a bool, "
                f"got {self.passed!r}",
            )
        return self

    @classmethod
    def from_payload(cls, entry: Mapping[str, Any]) -> "Measurement":
        _require(
            isinstance(entry, Mapping),
            f"measurement entry must be a mapping, got {type(entry).__name__}",
        )
        known = {"name", "params", "updates_per_sec", "wall_s", "passed"}
        rate = entry.get("updates_per_sec")
        wall = entry.get("wall_s")
        return cls(
            name=entry.get("name"),
            params=dict(entry.get("params") or {}),
            updates_per_sec=float(rate) if rate is not None else None,
            wall_s=float(wall) if wall is not None else None,
            passed=entry.get("passed"),
            extras={k: v for k, v in entry.items() if k not in known},
        ).validate()

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {"name": self.name, "params": _jsonable(self.params)}
        if self.updates_per_sec is not None:
            out["updates_per_sec"] = float(self.updates_per_sec)
        if self.wall_s is not None:
            out["wall_s"] = float(self.wall_s)
        if self.passed is not None:
            out["passed"] = bool(self.passed)
        out.update(_jsonable(self.extras))
        return out


@dataclasses.dataclass
class SectionRun:
    """One parsed ``BENCH_<section>.json`` artifact."""

    section: str
    measurements: List[Measurement]
    schema_version: int = SECTION_SCHEMA_VERSION
    git_commit_hash: str = "unknown"
    git_branch: str = "unknown"
    run_start_ts: str = ""
    run_end_ts: str = ""
    host: Dict[str, Any] = dataclasses.field(default_factory=dict)
    ci_run_id: Optional[str] = None
    source_path: str = ""  # where the artifact was read from (diagnostics)

    def validate(self) -> "SectionRun":
        _require(
            isinstance(self.section, str) and bool(self.section),
            f"section must be a non-empty string, got {self.section!r}",
        )
        _require(
            self.schema_version == SECTION_SCHEMA_VERSION,
            f"BENCH_{self.section}.json schema_version "
            f"{self.schema_version!r} unsupported "
            f"(this parser speaks version {SECTION_SCHEMA_VERSION})",
        )
        _require(
            isinstance(self.host, dict),
            f"section {self.section!r}: host must be a mapping",
        )
        for m in self.measurements:
            m.validate()
        return self

    @classmethod
    def from_payload(
        cls, payload: Mapping[str, Any], source_path: str = ""
    ) -> "SectionRun":
        _require(
            isinstance(payload, Mapping),
            f"{source_path or 'payload'}: BENCH payload must be a JSON "
            f"object, got {type(payload).__name__}",
        )
        _require(
            "section" in payload,
            f"{source_path or 'payload'}: missing required 'section' field",
        )
        raw = payload.get("measurements", [])
        _require(
            isinstance(raw, list),
            f"{source_path or 'payload'}: 'measurements' must be a list",
        )
        try:
            measurements = [Measurement.from_payload(m) for m in raw]
        except ModelError as e:
            raise ModelError(f"{source_path or 'payload'}: {e}") from None
        ci = payload.get("ci_run_id")
        return cls(
            section=payload["section"],
            measurements=measurements,
            schema_version=payload.get("schema_version", SECTION_SCHEMA_VERSION),
            git_commit_hash=payload.get("git_commit_hash", "unknown"),
            git_branch=payload.get("git_branch", "unknown"),
            run_start_ts=payload.get("run_start_ts", ""),
            run_end_ts=payload.get("run_end_ts", ""),
            host=dict(payload.get("host") or {}),
            ci_run_id=str(ci) if ci is not None else None,
            source_path=source_path,
        ).validate()

    @property
    def jax_version(self) -> Optional[str]:
        return self.host.get("jax_version")

    @property
    def backend(self) -> Optional[str]:
        return self.host.get("backend")

    @property
    def device_count(self) -> Optional[int]:
        n = self.host.get("device_count")
        return int(n) if n is not None else None


@dataclasses.dataclass
class NormalizedMeasurement:
    """One measurement of a :class:`RunRecord`, tagged with its section and
    CI matrix leg — the flat shape the history file stores."""

    section: str
    leg: str
    name: str
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)
    updates_per_sec: Optional[float] = None
    wall_s: Optional[float] = None
    passed: Optional[bool] = None
    extras: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def validate(self) -> "NormalizedMeasurement":
        _require(
            isinstance(self.section, str) and bool(self.section),
            f"normalized measurement needs a section, got {self.section!r}",
        )
        _require(
            isinstance(self.leg, str),
            f"leg must be a string, got {self.leg!r}",
        )
        Measurement(
            name=self.name,
            params=self.params,
            updates_per_sec=self.updates_per_sec,
            wall_s=self.wall_s,
            passed=self.passed,
        ).validate()
        return self

    def key(self) -> Tuple:
        """The cross-run identity the trend gate matches on."""
        return (self.section, self.leg, self.name, params_key(self.params))

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "section": self.section,
            "leg": self.leg,
            "name": self.name,
            "params": _jsonable(self.params),
        }
        if self.updates_per_sec is not None:
            out["updates_per_sec"] = float(self.updates_per_sec)
        if self.wall_s is not None:
            out["wall_s"] = float(self.wall_s)
        if self.passed is not None:
            out["passed"] = bool(self.passed)
        if self.extras:
            out["extras"] = _jsonable(self.extras)
        return out

    @classmethod
    def from_json(cls, entry: Mapping[str, Any]) -> "NormalizedMeasurement":
        rate = entry.get("updates_per_sec")
        wall = entry.get("wall_s")
        return cls(
            section=entry.get("section"),
            leg=entry.get("leg", ""),
            name=entry.get("name"),
            params=dict(entry.get("params") or {}),
            updates_per_sec=float(rate) if rate is not None else None,
            wall_s=float(wall) if wall is not None else None,
            passed=entry.get("passed"),
            extras=dict(entry.get("extras") or {}),
        ).validate()


@dataclasses.dataclass
class RunRecord:
    """One normalized CI (or local) run: every section artifact from every
    matrix leg, flattened — one line of ``perf_history.jsonl``.

    ``jax_version`` / ``backend`` ride along top-level so history entries
    stay comparable across toolchain bumps (a rate step that coincides with
    a jax upgrade is a toolchain note, not a code regression).
    """

    run_id: str
    git_commit_hash: str = "unknown"
    git_branch: str = "unknown"
    run_start_ts: str = ""
    run_end_ts: str = ""
    jax_version: Optional[str] = None
    backend: Optional[str] = None
    measurements: List[NormalizedMeasurement] = dataclasses.field(
        default_factory=list
    )
    schema_version: int = HISTORY_SCHEMA_VERSION

    def validate(self) -> "RunRecord":
        _require(
            isinstance(self.run_id, str) and bool(self.run_id),
            f"run_id must be a non-empty string, got {self.run_id!r}",
        )
        _require(
            self.schema_version == HISTORY_SCHEMA_VERSION,
            f"history record schema_version {self.schema_version!r} "
            f"unsupported (this reader speaks {HISTORY_SCHEMA_VERSION})",
        )
        seen = set()
        for m in self.measurements:
            m.validate()
            k = m.key()
            _require(
                k not in seen,
                f"run {self.run_id}: duplicate measurement key {k} — the "
                f"artifact sweep must dedupe before normalizing",
            )
            seen.add(k)
        return self

    def sections(self) -> Tuple[str, ...]:
        return tuple(sorted({m.section for m in self.measurements}))

    def legs(self) -> Tuple[str, ...]:
        return tuple(sorted({m.leg for m in self.measurements}))

    def by_key(self) -> Dict[Tuple, NormalizedMeasurement]:
        return {m.key(): m for m in self.measurements}

    def to_json(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {
            "schema_version": self.schema_version,
            "run_id": self.run_id,
            "git_commit_hash": self.git_commit_hash,
            "git_branch": self.git_branch,
            "run_start_ts": self.run_start_ts,
            "run_end_ts": self.run_end_ts,
            "measurements": [m.to_json() for m in self.measurements],
        }
        if self.jax_version is not None:
            out["jax_version"] = self.jax_version
        if self.backend is not None:
            out["backend"] = self.backend
        return out

    def to_jsonl(self) -> str:
        return json.dumps(self.to_json(), sort_keys=True)

    @classmethod
    def from_json(cls, payload: Mapping[str, Any]) -> "RunRecord":
        _require(
            isinstance(payload, Mapping),
            f"history record must be a JSON object, "
            f"got {type(payload).__name__}",
        )
        raw = payload.get("measurements", [])
        _require(isinstance(raw, list), "history record: measurements must be a list")
        return cls(
            run_id=payload.get("run_id"),
            git_commit_hash=payload.get("git_commit_hash", "unknown"),
            git_branch=payload.get("git_branch", "unknown"),
            run_start_ts=payload.get("run_start_ts", ""),
            run_end_ts=payload.get("run_end_ts", ""),
            jax_version=payload.get("jax_version"),
            backend=payload.get("backend"),
            measurements=[NormalizedMeasurement.from_json(m) for m in raw],
            schema_version=payload.get("schema_version", HISTORY_SCHEMA_VERSION),
        ).validate()
