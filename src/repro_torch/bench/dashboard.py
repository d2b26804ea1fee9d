"""Static perf dashboard over the cross-run report (a copy of
``repro.bench.dashboard``).

Renders ``BENCH_report.json`` (the machine-readable rate series
``repro_torch.bench.report`` emits — the ROADMAP's named dashboard input) into
one self-contained HTML file: an inline-SVG sparkline per measurement
series, latest/median/best columns, and a marker on every run where the
recorded ``jax_version`` changed (toolchain bumps are the usual suspect
behind an otherwise unexplained rate step).

No external assets, no JavaScript frameworks — the file is an artifact
the perf-history CI job uploads next to the report, viewable offline.

Usage::

    python -m repro_torch.bench.dashboard --report report/BENCH_report.json \
        --out report/dashboard.html
    python -m repro_torch.bench.dashboard --history perf_history.jsonl \
        --out dashboard.html          # build the payload in-process
"""
from __future__ import annotations

import argparse
import html
import json
import os
from typing import Any, Dict, List, Optional

SPARK_W, SPARK_H = 220, 36
_PAD = 3  # sparkline inner padding, px


def _fmt_rate(rate: float) -> str:
    return f"{rate:,.0f}"


def _spark_points(rates: List[float]) -> List[tuple]:
    """(x, y) pixel coordinates, y normalized over the series range."""
    lo, hi = min(rates), max(rates)
    span = (hi - lo) or 1.0
    n = len(rates)
    xs = (
        [SPARK_W / 2.0]
        if n == 1
        else [_PAD + i * (SPARK_W - 2 * _PAD) / (n - 1) for i in range(n)]
    )
    ys = [
        SPARK_H - _PAD - (r - lo) / span * (SPARK_H - 2 * _PAD) for r in rates
    ]
    return list(zip(xs, ys))


def _sparkline(points: List[Dict[str, Any]]) -> str:
    """Inline SVG: the rate polyline plus a marker wherever jax_version
    changed from the previous run (hover shows the new version)."""
    rates = [float(p["updates_per_sec"]) for p in points]
    coords = _spark_points(rates)
    poly = " ".join(f"{x:.1f},{y:.1f}" for x, y in coords)
    parts = [
        f'<svg width="{SPARK_W}" height="{SPARK_H}" '
        f'viewBox="0 0 {SPARK_W} {SPARK_H}" class="spark">',
        f'<polyline points="{poly}" fill="none" stroke="#2c7fb8" '
        f'stroke-width="1.5"/>',
    ]
    prev_jax: Optional[str] = None
    for (x, y), p in zip(coords, points):
        jax_v = p.get("jax_version")
        if jax_v is not None and prev_jax is not None and jax_v != prev_jax:
            label = html.escape(f"jax {prev_jax} -> {jax_v}")
            parts.append(
                f'<circle cx="{x:.1f}" cy="{y:.1f}" r="3" fill="#d95f0e">'
                f"<title>{label}</title></circle>"
            )
        if jax_v is not None:
            prev_jax = jax_v
    # terminal dot: where the series stands now
    x, y = coords[-1]
    parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="2" fill="#2c7fb8"/>')
    parts.append("</svg>")
    return "".join(parts)


def _series_label(s: Dict[str, Any]) -> str:
    label = f"{s['section']}/{s['name']}"
    if s.get("leg"):
        label += f"@{s['leg']}"
    return label


def _series_row(s: Dict[str, Any]) -> str:
    points = s["points"]
    rates = [float(p["updates_per_sec"]) for p in points]
    latest = rates[-1]
    median = float(s["median_updates_per_sec"])
    delta = (latest - median) / median if median > 0 else 0.0
    cls = "up" if delta >= 0 else ("down" if delta < -0.10 else "flat")
    params = ",".join(
        f"{k}={v}" for k, v in sorted(s.get("params", {}).items())[:3]
    )
    return (
        "<tr>"
        f"<td class=\"name\">{html.escape(_series_label(s))}"
        f"<div class=\"params\">{html.escape(params)}</div></td>"
        f"<td>{html.escape(str(s.get('engine', '-')))}</td>"
        f"<td class=\"num\">{s.get('k', 1)}</td>"
        f"<td class=\"num\">{s.get('d', 1)}</td>"
        f"<td>{html.escape(str(s.get('source', '-')))}</td>"
        f"<td>{_sparkline(points)}</td>"
        f"<td class=\"num\">{len(points)}</td>"
        f"<td class=\"num\">{_fmt_rate(latest)}</td>"
        f"<td class=\"num\">{_fmt_rate(median)}</td>"
        f"<td class=\"num\">{_fmt_rate(max(rates))}</td>"
        f"<td class=\"num {cls}\">{delta:+.1%}</td>"
        "</tr>"
    )


_STYLE = """
body { font: 13px/1.45 system-ui, sans-serif; margin: 24px; color: #222; }
h1 { font-size: 18px; } .meta { color: #666; margin-bottom: 16px; }
table { border-collapse: collapse; width: 100%; }
th, td { padding: 4px 8px; border-bottom: 1px solid #e5e5e5;
         text-align: left; vertical-align: middle; }
th { border-bottom: 2px solid #bbb; position: sticky; top: 0;
     background: #fff; }
td.num, th.num { text-align: right; font-variant-numeric: tabular-nums; }
td.name { font-weight: 600; }
.params { font-weight: 400; color: #888; font-size: 11px; }
.up { color: #1a7f37; } .down { color: #b42318; } .flat { color: #666; }
.spark { display: block; }
.legend { margin-top: 12px; color: #666; font-size: 12px; }
.legend .dot { color: #d95f0e; }
"""


def render_dashboard(payload: Dict[str, Any]) -> str:
    series = payload.get("series", [])
    rows = "\n".join(_series_row(s) for s in series)
    if not rows:
        rows = ("<tr><td colspan=\"11\">no rate measurements in the "
                "report</td></tr>")
    return f"""<!doctype html>
<html lang="en"><head><meta charset="utf-8">
<title>repro perf dashboard</title>
<style>{_STYLE}</style></head>
<body>
<h1>Benchmark rate trajectory</h1>
<div class="meta">{payload.get('n_runs', 0)} run(s) in history;
rolling window {payload.get('window', 5)};
{len(series)} measurement series.</div>
<table>
<thead><tr><th>measurement</th><th>engine</th><th class="num">K</th>
<th class="num">D</th><th>source</th><th>trend</th>
<th class="num">runs</th><th class="num">latest /s</th>
<th class="num">median /s</th><th class="num">best /s</th>
<th class="num">vs median</th></tr></thead>
<tbody>
{rows}
</tbody>
</table>
<div class="legend"><span class="dot">&#9679;</span> jax version changed
on that run (hover for old &rarr; new); blue dot marks the latest run.</div>
</body></html>
"""


def write_dashboard(payload: Dict[str, Any], out_path: str) -> str:
    out_dir = os.path.dirname(out_path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    with open(out_path, "w") as f:
        f.write(render_dashboard(payload))
    return out_path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.bench.dashboard",
        description="static HTML dashboard over BENCH_report.json",
    )
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--report", default=None,
                     help="BENCH_report.json from repro_torch.bench.report")
    src.add_argument("--history", default=None,
                     help="perf-history JSONL (payload built in-process)")
    ap.add_argument("--out", default="dashboard.html")
    ap.add_argument("--window", type=int, default=5)
    args = ap.parse_args(argv)

    if args.report is not None:
        with open(args.report) as f:
            payload = json.load(f)
    else:
        from .history import default_history_path, load_history
        from .report import report_payload

        history_path = args.history or default_history_path()
        runs, problems = load_history(history_path)
        for p in problems:
            print(f"dashboard,unreadable,{p}")
        if not runs:
            print(f"dashboard,error,no runs in {history_path}")
            return 1
        payload = report_payload(runs, window=args.window)

    path = write_dashboard(payload, args.out)
    print(
        f"dashboard,written,series={len(payload.get('series', []))},"
        f"html={path}"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
