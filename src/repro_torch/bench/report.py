"""Cross-run perf report: updates/s per engine × K × D × source (a copy of
``repro.bench.report``).

Reads the committed perf history (plus, optionally, a fresh artifact tree
not yet appended) and emits:

* ``BENCH_report.json`` — machine-readable rate series: one entry per
  (engine, K, D, source, section, name, leg, params) measurement key, with
  one point per run across the repo's life (the input for a dashboard —
  the ROADMAP's named follow-on);
* ``BENCH_report.md`` — the human summary table: latest rate vs the
  rolling median, per series.

The dimension columns are derived from each measurement's own params
(``engine`` / ``k_per_device`` / ``n_devices``) with documented per-section
fallbacks where a bench predates the dimension (e.g. the serve bench's
engine is the session's auto pick: ``single`` at K=1, ``packed`` at K>1 on
CPU hosts).

Usage::

    python -m repro_torch.bench.report [--history perf_history.jsonl] \
        [--fresh bench-artifacts] [--out report-dir] [--window 5]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
from typing import Any, Dict, List, Optional, Tuple

from .history import default_history_path, load_history
from .models import NormalizedMeasurement, RunRecord
from .parsers import normalize_dir

REPORT_SCHEMA_VERSION = 1

#: engine fallback when a measurement's params don't carry one
_SECTION_ENGINE = {
    "hier_update": "single",
    "scaling": "mesh",
    "embed_grad": "single",
    "kernels": "kernel-ref",
}

#: source fallback per section (what traffic fed the measurement)
_SECTION_SOURCE = {
    "hier_update": "rmat",
    "scaling": "rmat",
    "cascade_kernel": "synthetic",
    "kernels": "synthetic",
    "embed_grad": "tokens",
}

#: serve measurements name their ingress path, not a params field
_SERVE_SOURCE = {
    "raw_engine_rate": "preroute",
    "served_rate": "array",
    "socket_rate": "tcp",
}


def measurement_dims(m: NormalizedMeasurement) -> Dict[str, Any]:
    """The (engine, k, d, source) axes of one measurement."""
    p = m.params
    k = p.get("k_per_device", p.get("k", 1))
    d = p.get("n_devices")
    if d is None and m.leg.startswith("d") and m.leg[1:].isdigit():
        d = int(m.leg[1:])
    engine = p.get("engine")
    if engine is None:
        if m.section == "serve":
            engine = "single" if int(k) == 1 else "packed"
        else:
            engine = _SECTION_ENGINE.get(m.section, "-")
    source = p.get("source")
    if source is None:
        if m.section == "serve":
            source = _SERVE_SOURCE.get(m.name, "array")
        else:
            source = _SECTION_SOURCE.get(m.section, "-")
    return {
        "engine": str(engine),
        "k": int(k),
        "d": int(d) if d is not None else 1,
        "source": str(source),
    }


@dataclasses.dataclass
class RateSeries:
    """One measurement key's rate trajectory across runs."""

    section: str
    name: str
    leg: str
    dims: Dict[str, Any]
    params: Dict[str, Any]
    points: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def latest(self) -> float:
        return self.points[-1]["updates_per_sec"]

    def median(self, window: int = 5) -> float:
        rates = [p["updates_per_sec"] for p in self.points[-window:]]
        return statistics.median(rates)

    def to_json(self, window: int = 5) -> Dict[str, Any]:
        return {
            "section": self.section,
            "name": self.name,
            "leg": self.leg,
            **self.dims,
            "params": self.params,
            "n_runs": len(self.points),
            "latest_updates_per_sec": self.latest(),
            "median_updates_per_sec": self.median(window),
            "best_updates_per_sec": max(
                p["updates_per_sec"] for p in self.points
            ),
            "points": self.points,
        }


def build_series(
    runs: List[RunRecord],
) -> List[RateSeries]:
    """Group every rate-carrying measurement across runs (oldest-first)."""
    series: Dict[Tuple, RateSeries] = {}
    for run in runs:
        for m in run.measurements:
            if m.updates_per_sec is None:
                continue
            key = m.key()
            if key not in series:
                series[key] = RateSeries(
                    section=m.section,
                    name=m.name,
                    leg=m.leg,
                    dims=measurement_dims(m),
                    params=dict(m.params),
                )
            series[key].points.append(
                {
                    "run_id": run.run_id,
                    "git_commit_hash": run.git_commit_hash,
                    "run_end_ts": run.run_end_ts,
                    "jax_version": run.jax_version,
                    "updates_per_sec": m.updates_per_sec,
                }
            )
    return [series[k] for k in sorted(series)]


def report_payload(
    runs: List[RunRecord], window: int = 5
) -> Dict[str, Any]:
    all_series = build_series(runs)
    return {
        "schema_version": REPORT_SCHEMA_VERSION,
        "n_runs": len(runs),
        "run_ids": [r.run_id for r in runs],
        "window": window,
        "series": [s.to_json(window) for s in all_series],
    }


def _fmt_rate(rate: float) -> str:
    return f"{rate:,.0f}"


def report_markdown(runs: List[RunRecord], window: int = 5) -> str:
    """The human-readable trajectory table."""
    all_series = build_series(runs)
    lines = [
        "# Benchmark rate trajectory",
        "",
        f"{len(runs)} run(s) in history; rolling window {window}.",
        "",
        "| measurement | engine | K | D | source | runs | first | latest "
        "| vs median |",
        "|---|---|---:|---:|---|---:|---:|---:|---:|",
    ]
    for s in all_series:
        label = f"{s.section}/{s.name}" + (f"@{s.leg}" if s.leg else "")
        short = ",".join(
            f"{k}={v}" for k, v in sorted(s.params.items())[:2]
        )
        if short:
            label += f" [{short}]"
        first = s.points[0]["updates_per_sec"]
        latest = s.latest()
        med = s.median(window)
        delta = (latest - med) / med if med > 0 else 0.0
        lines.append(
            f"| {label} | {s.dims['engine']} | {s.dims['k']} | {s.dims['d']} "
            f"| {s.dims['source']} | {len(s.points)} | {_fmt_rate(first)} "
            f"| {_fmt_rate(latest)} | {delta:+.1%} |"
        )
    if not all_series:
        lines.append("| (no rate measurements in history) | | | | | | | | |")
    lines.append("")
    return "\n".join(lines)


def write_report(
    runs: List[RunRecord], out_dir: str, window: int = 5
) -> Tuple[str, str]:
    os.makedirs(out_dir, exist_ok=True)
    json_path = os.path.join(out_dir, "BENCH_report.json")
    md_path = os.path.join(out_dir, "BENCH_report.md")
    with open(json_path, "w") as f:
        json.dump(report_payload(runs, window), f, indent=2)
        f.write("\n")
    with open(md_path, "w") as f:
        f.write(report_markdown(runs, window))
    return json_path, md_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.report",
        description="cross-run perf report over the committed history",
    )
    ap.add_argument("--history", default=None,
                    help="perf-history JSONL (default: the committed one)")
    ap.add_argument("--fresh", default=None,
                    help="optional artifact tree appended as the newest run")
    ap.add_argument("--out", default=".", help="output directory")
    ap.add_argument("--window", type=int, default=5)
    args = ap.parse_args(argv)

    history_path = args.history or default_history_path()
    runs, problems = load_history(history_path)
    for p in problems:
        print(f"report,unreadable,{p}")
    if args.fresh is not None:
        try:
            fresh, fresh_problems = normalize_dir(args.fresh, strict=False)
            for p in fresh_problems:
                print(f"report,unreadable,{p}")
            if not any(r.run_id == fresh.run_id for r in runs):
                runs.append(fresh)
        except Exception as e:
            print(f"report,warning,no fresh artifacts folded in ({e})")
    if not runs:
        print(f"report,error,no runs in {history_path} and no --fresh artifacts")
        return 1
    json_path, md_path = write_report(runs, args.out, window=args.window)
    n_series = len(build_series(runs))
    print(
        f"report,written,runs={len(runs)},series={n_series},"
        f"json={json_path},md={md_path}"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
