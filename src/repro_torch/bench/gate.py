"""Trend-based benchmark regression gate (port of ``repro.bench.gate``, on
the port's own history file).

The legacy gate diffed fresh ``BENCH_<section>.json`` artifacts
against *one* baseline — the previous CI artifact — so a single noisy
sample could trip (or mask) a regression.  This gate tests every fresh
measurement against a **rolling-window trend** over the committed perf
history (``src/repro_torch/benchmarks/history/perf_history.jsonl``): the median rate of the
last ``--window`` runs that measured the same (section, leg, name, params)
key.  The median absorbs a single outlier run on either side; a real step
change moves the fresh sample away from the whole window and trips.

Thresholds keep the ROADMAP convention:

* fresh rate below trend by > ``--fail`` (default 30%) -> exit 1;
* below trend by > ``--warn`` (default 10%) -> warning line, exit 0;
* boolean ``passed`` verdicts: fresh ``False`` while the window majority is
  ``True`` -> exit 1 (a structural property broke, not just a rate);
* a key with no history yet -> informational ``new`` line (first
  measurement of a new bench/config must not block CI);
* no history at all (and no legacy baseline) -> clean
  ``baseline-established`` pass: this run's record becomes the trend.

Compatibility: ``--baseline <dir>`` (the legacy previous-artifact mode) is
still accepted — the directory is normalized into a one-entry history, so a
single-sample diff is just a window of size 1.

Usage::

    python -m repro_torch.bench.gate --fresh bench-artifacts \
        [--history src/repro_torch/benchmarks/history/perf_history.jsonl] \
        [--baseline bench-baseline] [--warn 0.10] [--fail 0.30] [--window 5]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
from typing import Dict, List, Optional, Tuple

from .history import default_history_path, load_history
from .models import RunRecord, params_key
from .parsers import normalize_dir, sweep_section_runs

DEFAULT_WARN = 0.10
DEFAULT_FAIL = 0.30
DEFAULT_WINDOW = 5


def load_measurements(dir_path: str) -> Dict[Tuple, dict]:
    """Legacy helper: flat ``(section, name, params) -> measurement`` map of
    every artifact under ``dir_path``."""
    runs, problems = sweep_section_runs(dir_path, strict=False)
    for p in problems:
        print(f"gate,unreadable,{p}")
    out: Dict[Tuple, dict] = {}
    for run in runs:
        for m in run.measurements:
            out[(run.section, m.name, params_key(m.params))] = m.to_json()
    return out


@dataclasses.dataclass
class GateFinding:
    tag: str  # "ok" | "WARN" | "FAIL" | "new"
    label: str
    detail: str = ""


@dataclasses.dataclass
class GateResult:
    findings: List[GateFinding] = dataclasses.field(default_factory=list)
    compared: int = 0
    new: int = 0
    baseline_established: bool = False

    @property
    def warned(self) -> List[GateFinding]:
        return [f for f in self.findings if f.tag == "WARN"]

    @property
    def failed(self) -> List[GateFinding]:
        return [f for f in self.findings if f.tag == "FAIL"]

    @property
    def passed(self) -> bool:
        return not self.failed


def _label(key: Tuple) -> str:
    section, leg, name, pkey = key
    short = ",".join(f"{k}={v}" for k, v in list(pkey)[:3])
    out = f"{section}/{name}"
    if leg:
        out += f"@{leg}"
    if short:
        out += f"[{short}]"
    return out


def gate_run(
    fresh: RunRecord,
    history: List[RunRecord],
    warn: float = DEFAULT_WARN,
    fail: float = DEFAULT_FAIL,
    window: int = DEFAULT_WINDOW,
) -> GateResult:
    """Gate one fresh run against the rolling-window trend of ``history``
    (oldest-first, as :func:`repro_torch.bench.history.load_history` returns it)."""
    result = GateResult()
    if not history:
        result.baseline_established = True
        return result

    # newest-first per-key series over the whole history
    by_key_series: Dict[Tuple, List] = {}
    for record in reversed(history):
        for key, m in record.by_key().items():
            by_key_series.setdefault(key, []).append(m)

    for key, fm in sorted(fresh.by_key().items()):
        series = by_key_series.get(key, [])
        label = _label(key)
        if fm.updates_per_sec is not None:
            rates = [
                m.updates_per_sec for m in series if m.updates_per_sec is not None
            ][: max(1, int(window))]
            if not rates:
                result.new += 1
                result.findings.append(
                    GateFinding("new", label, f"fresh={fm.updates_per_sec:,.0f}/s")
                )
                continue
            trend = statistics.median(rates)
            if trend <= 0:
                continue
            result.compared += 1
            drop = (trend - fm.updates_per_sec) / trend
            tag = "ok"
            if drop > fail:
                tag = "FAIL"
            elif drop > warn:
                tag = "WARN"
            result.findings.append(
                GateFinding(
                    tag,
                    label,
                    f"trend={trend:,.0f}/s(n={len(rates)}),"
                    f"fresh={fm.updates_per_sec:,.0f}/s,drop={drop:+.1%}",
                )
            )
        elif fm.passed is not None:
            verdicts = [m.passed for m in series if m.passed is not None][
                : max(1, int(window))
            ]
            if not verdicts:
                result.new += 1
                result.findings.append(
                    GateFinding("new", label, f"verdict={fm.passed}")
                )
                continue
            result.compared += 1
            trend_true = sum(verdicts) * 2 > len(verdicts)  # window majority
            if trend_true and not fm.passed:
                result.findings.append(
                    GateFinding(
                        "FAIL",
                        label,
                        f"verdict regressed true -> false "
                        f"(window {sum(verdicts)}/{len(verdicts)} true)",
                    )
                )
            else:
                result.findings.append(
                    GateFinding("ok", label, f"verdict={fm.passed}")
                )
    return result


def _print_result(result: GateResult) -> int:
    for f in result.findings:
        print(f"gate,{f.tag},{f.label},{f.detail}")
    print(
        f"gate,summary,compared={result.compared},"
        f"warned={len(result.warned)},failed={len(result.failed)},"
        f"new={result.new}"
    )
    if result.failed:
        labels = ", ".join(f.label for f in result.failed)
        print(f"gate,verdict,FAIL,regressions: {labels}")
        return 1
    print("gate,verdict,PASS")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.gate",
        description="trend-based benchmark regression gate",
    )
    ap.add_argument("--fresh", required=True,
                    help="directory tree with this run's BENCH_*.json")
    ap.add_argument("--history", default=None,
                    help="perf-history JSONL to derive the trend from "
                         "(default: the committed "
                         "src/repro_torch/benchmarks/history/perf_history.jsonl, unless "
                         "--baseline is given)")
    ap.add_argument("--baseline", default=None,
                    help="legacy mode: previous run's artifact directory, "
                         "folded in as the most recent history entry")
    ap.add_argument("--warn", type=float, default=DEFAULT_WARN,
                    help=f"trend-drop fraction that warns (default {DEFAULT_WARN})")
    ap.add_argument("--fail", type=float, default=DEFAULT_FAIL,
                    help=f"trend-drop fraction that fails (default {DEFAULT_FAIL})")
    ap.add_argument("--window", type=int, default=DEFAULT_WINDOW,
                    help=f"rolling-window size (default {DEFAULT_WINDOW} runs)")
    args = ap.parse_args(argv)

    try:
        fresh, problems = normalize_dir(args.fresh, strict=False)
    except Exception as e:
        print(f"gate,error,no fresh BENCH_*.json under {args.fresh} ({e})")
        return 1
    for p in problems:
        print(f"gate,unreadable,{p}")

    history: List[RunRecord] = []
    history_path: Optional[str] = args.history
    if history_path is None and args.baseline is None:
        default = default_history_path()
        if os.path.exists(default):
            history_path = default
    if history_path is not None:
        records, hist_problems = load_history(history_path)
        for p in hist_problems:
            print(f"gate,unreadable,{p}")
        history.extend(records)
        print(f"gate,history,{len(records)} run(s) from {history_path}")
    if args.baseline is not None and os.path.isdir(args.baseline):
        try:
            baseline_record, base_problems = normalize_dir(
                args.baseline, run_id="baseline", strict=False
            )
            for p in base_problems:
                print(f"gate,unreadable,{p}")
            history.append(baseline_record)  # most recent trend entry
        except Exception:
            pass  # unreadable baseline == no baseline (legacy contract)

    result = gate_run(
        fresh, history, warn=args.warn, fail=args.fail, window=args.window
    )
    if result.baseline_established:
        where = args.history or args.baseline or "history"
        print(
            f"gate,baseline-established,{len(fresh.measurements)} fresh "
            f"measurement(s), no baseline under {where} - nothing to compare"
        )
        print("gate,verdict,PASS")
        return 0
    return _print_result(result)


if __name__ == "__main__":
    sys.exit(main())
