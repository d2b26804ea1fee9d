"""Sweep multi-leg CI artifact trees into one normalized run record (a
copy of ``repro.bench.parsers``).

A CI run scatters ``BENCH_<section>.json`` files across matrix legs —
``benchmark-json-d1/``, ``benchmark-json-d8/``, ``benchmark-json-serve/``
(or one flat ``bench-artifacts/`` directory for a single local run).
:func:`sweep_section_runs` walks the tree and validates every payload into
a :class:`~repro_torch.bench.models.SectionRun`; :func:`normalize_run` folds them
into one :class:`~repro_torch.bench.models.RunRecord` — the unit the history
file, the trend gate, and the report generator all speak.

Legs are labelled from the payload itself (``d<device_count>`` from the
recorded host info), not from directory names: artifacts self-describe, so
a renamed download directory can't silently fork a measurement's history.
When the same (section, leg, name, params) key appears twice in one sweep
(e.g. the serve section runs both in the serve-smoke job and the d1 bench
leg), the later-timestamped artifact wins — re-runs overwrite, never
duplicate.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Iterable, List, Optional, Tuple

from .models import (
    ModelError,
    NormalizedMeasurement,
    RunRecord,
    SectionRun,
)


def find_bench_files(root: str) -> List[str]:
    """Every ``BENCH_*.json`` under ``root`` (recursive, sorted).

    ``BENCH_report.json`` is the *output* of the report generator, not a
    section artifact — it is never swept back in.
    """
    out: List[str] = []
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            if (
                name.startswith("BENCH_")
                and name.endswith(".json")
                and name != "BENCH_report.json"
            ):
                out.append(os.path.join(dirpath, name))
    return sorted(out)


def parse_section_file(path: str) -> SectionRun:
    """Parse + validate one ``BENCH_<section>.json`` file."""
    try:
        with open(path) as f:
            payload = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise ModelError(f"{path}: unreadable BENCH payload ({e})") from None
    return SectionRun.from_payload(payload, source_path=path)


def sweep_section_runs(
    root: str, strict: bool = True
) -> Tuple[List[SectionRun], List[str]]:
    """Parse every artifact under ``root``.

    Returns ``(runs, problems)``.  ``strict=True`` raises on the first
    malformed payload (the history appender must never ingest garbage);
    ``strict=False`` collects human-readable problem strings instead (the
    gate tolerates a torn artifact the same way the legacy gate did).
    """
    runs: List[SectionRun] = []
    problems: List[str] = []
    for path in find_bench_files(root):
        try:
            runs.append(parse_section_file(path))
        except ModelError as e:
            if strict:
                raise
            problems.append(str(e))
    return runs, problems


def leg_label(run: SectionRun) -> str:
    """The matrix-leg label of one artifact: ``d<device_count>`` when the
    payload recorded its host, else ''."""
    n = run.device_count
    return f"d{n}" if n is not None else ""


def normalize_run(
    section_runs: Iterable[SectionRun],
    run_id: Optional[str] = None,
) -> RunRecord:
    """Fold validated section artifacts into one :class:`RunRecord`.

    Provenance (commit, branch, jax version, backend) is taken from the
    artifacts themselves — first non-unknown value wins; the run window is
    the min/max of the per-section timestamps.  ``run_id`` defaults to the
    artifacts' ``ci_run_id`` and falls back to ``local-<commit>``.
    """
    section_runs = list(section_runs)
    if not section_runs:
        raise ModelError("normalize_run: no section artifacts to normalize")

    def first(values: Iterable[Optional[str]], default: str) -> str:
        for v in values:
            if v and v != "unknown":
                return v
        return default

    commit = first((r.git_commit_hash for r in section_runs), "unknown")
    branch = first((r.git_branch for r in section_runs), "unknown")
    jax_version = first((r.jax_version for r in section_runs), "") or None
    backend = first((r.backend for r in section_runs), "") or None
    if run_id is None:
        run_id = first((r.ci_run_id for r in section_runs), "") or (
            f"local-{commit[:12]}"
        )
    starts = sorted(r.run_start_ts for r in section_runs if r.run_start_ts)
    ends = sorted(r.run_end_ts for r in section_runs if r.run_end_ts)

    # later-timestamped artifact wins a key collision (re-runs overwrite)
    ordered = sorted(section_runs, key=lambda r: (r.run_start_ts, r.source_path))
    merged: Dict[Tuple, NormalizedMeasurement] = {}
    for run in ordered:
        leg = leg_label(run)
        for m in run.measurements:
            nm = NormalizedMeasurement(
                section=run.section,
                leg=leg,
                name=m.name,
                params=dict(m.params),
                updates_per_sec=m.updates_per_sec,
                wall_s=m.wall_s,
                passed=m.passed,
                extras=dict(m.extras),
            ).validate()
            merged[nm.key()] = nm

    return RunRecord(
        run_id=str(run_id),
        git_commit_hash=commit,
        git_branch=branch,
        run_start_ts=starts[0] if starts else "",
        run_end_ts=ends[-1] if ends else "",
        jax_version=jax_version,
        backend=backend,
        measurements=[merged[k] for k in sorted(merged)],
    ).validate()


def normalize_dir(
    root: str, run_id: Optional[str] = None, strict: bool = True
) -> Tuple[RunRecord, List[str]]:
    """``sweep_section_runs`` + ``normalize_run`` in one call.

    Returns ``(record, problems)``; raises :class:`ModelError` when the
    tree holds no parseable artifact at all.
    """
    runs, problems = sweep_section_runs(root, strict=strict)
    if not runs:
        raise ModelError(
            f"no BENCH_*.json artifacts under {root}"
            + (f" ({len(problems)} unreadable)" if problems else "")
        )
    return normalize_run(runs, run_id=run_id), problems
