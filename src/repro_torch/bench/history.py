"""The port's perf-history file:
``src/repro_torch/benchmarks/history/perf_history.jsonl`` (port of
``repro.bench.history``).

The port keeps its own history, apart from the reference's
``benchmarks/history/perf_history.jsonl``: the gate keys a measurement by
(section, leg, name, params) and never by backend, so a card run appended
to the reference's file would trend against its CPU runs.  The file starts
absent, which the gate reads as a clean, baseline-established pass.

One line per CI run (a :class:`~repro.bench.models.RunRecord`), appended by
the ``perf-history`` CI job and committed on ``main`` — the repo carries its
own rate trajectory, so the regression gate tests fresh numbers against a
rolling-window *trend* instead of one possibly-noisy previous sample, and
the report generator can plot updates/s per engine × K × D × source across
the repo's life.

CLI::

    python -m repro_torch.bench.history append --fresh <artifact-tree> \
        [--history src/repro_torch/benchmarks/history/perf_history.jsonl] [--run-id ID]
    python -m repro_torch.bench.history show [--history ...] [--last N]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import List, Optional, Tuple

from .models import ModelError, RunRecord
from .parsers import normalize_dir

#: repo-relative location of the port's history file
DEFAULT_HISTORY_RELPATH = os.path.join(
    "src", "repro_torch", "benchmarks", "history", "perf_history.jsonl"
)


def default_history_path() -> str:
    """The port's history file, resolved relative to this package."""
    package = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(package, "benchmarks", "history", "perf_history.jsonl")


def load_history(path: str, strict: bool = False) -> Tuple[List[RunRecord], List[str]]:
    """Read the history file oldest-first.

    Returns ``(records, problems)``.  A missing file is an empty history
    (the baseline-established case), never an error.  Corrupt lines raise
    under ``strict`` and are skipped-with-note otherwise — the gate must
    keep working even if one bad line ever lands.
    """
    records: List[RunRecord] = []
    problems: List[str] = []
    if not os.path.exists(path):
        return records, problems
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(RunRecord.from_json(json.loads(line)))
            except (json.JSONDecodeError, ModelError) as e:
                msg = f"{path}:{lineno}: unreadable history line ({e})"
                if strict:
                    raise ModelError(msg) from None
                problems.append(msg)
    return records, problems


def append_run(record: RunRecord, path: str) -> str:
    """Append one validated record as a JSONL line; returns ``path``."""
    record.validate()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(record.to_jsonl() + "\n")
    return path


def append_fresh_artifacts(
    fresh_dir: str,
    history_path: str,
    run_id: Optional[str] = None,
    dedupe_run_id: bool = True,
) -> RunRecord:
    """Normalize an artifact tree and append it to the history.

    ``dedupe_run_id=True`` makes the append idempotent per CI run: a
    re-triggered workflow with the same ``run_id`` replaces nothing and
    appends nothing the second time (the first record stands).
    """
    record, _ = normalize_dir(fresh_dir, run_id=run_id, strict=True)
    if dedupe_run_id:
        existing, _ = load_history(history_path)
        if any(r.run_id == record.run_id for r in existing):
            return record
    append_run(record, history_path)
    return record


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.history",
        description=__doc__.splitlines()[0],
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    ap_append = sub.add_parser(
        "append", help="normalize an artifact tree and append it"
    )
    ap_append.add_argument("--fresh", required=True,
                           help="directory tree holding BENCH_*.json artifacts")
    ap_append.add_argument("--history", default=None,
                           help=f"history file (default: {DEFAULT_HISTORY_RELPATH})")
    ap_append.add_argument("--run-id", default=None,
                           help="override the run id (default: artifacts' "
                                "ci_run_id, else local-<commit>)")
    ap_append.add_argument("--allow-duplicate-run-id", action="store_true",
                           help="append even when the run id is already in "
                                "the history (default: idempotent skip)")

    ap_show = sub.add_parser("show", help="print the history summary")
    ap_show.add_argument("--history", default=None)
    ap_show.add_argument("--last", type=int, default=10)

    args = ap.parse_args(argv)
    history_path = args.history or default_history_path()

    if args.cmd == "append":
        try:
            record = append_fresh_artifacts(
                args.fresh,
                history_path,
                run_id=args.run_id,
                dedupe_run_id=not args.allow_duplicate_run_id,
            )
        except ModelError as e:
            print(f"history,error,{e}")
            return 1
        print(
            f"history,appended,run_id={record.run_id},"
            f"commit={record.git_commit_hash[:12]},"
            f"sections={'+'.join(record.sections())},"
            f"legs={'+'.join(l or '-' for l in record.legs())},"
            f"measurements={len(record.measurements)},path={history_path}"
        )
        return 0

    records, problems = load_history(history_path)
    for p in problems:
        print(f"history,unreadable,{p}")
    print(f"history,{len(records)} run(s),path={history_path}")
    for r in records[-args.last:]:
        rates = sum(1 for m in r.measurements if m.updates_per_sec is not None)
        print(
            f"history,run,run_id={r.run_id},commit={r.git_commit_hash[:12]},"
            f"branch={r.git_branch},end={r.run_end_ts},"
            f"jax={r.jax_version or '?'},measurements={len(r.measurements)},"
            f"rates={rates}"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
