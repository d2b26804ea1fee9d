"""``repro_torch.bench`` against ``repro.bench`` on the same inputs.

Every case of ``tests/bench/*.py`` and ``tests/benchmarks/
test_regression_gate.py`` runs once through each package (the same
fixture artifacts, histories and configs, in a directory of its own) with
the reference test's assertions, and the two packages' results must be
equal: normalized records, gate findings and exit codes, report JSON and
Markdown, dashboard HTML, spec expansion and validation.  The reference's
legacy gate and writer shims (``benchmarks/regression_gate.py``,
``benchmarks/reporting.py``) are held to the port's ``bench.gate`` and
``bench`` themselves: the port has no shims and no legacy run flags, so
the cases of ``ExperimentSpec.from_legacy`` stay with the reference's
tests.
The port's own differences (host info, default directories, its history
file, ``--device``) are held at the end.
"""
import dataclasses
import json
import os
import sys
import types

import pytest

import benchmarks.regression_gate as ref_legacy_gate
import benchmarks.reporting as ref_legacy_reporting
import benchmarks.run as ref_run
import repro.bench as ref_bench
import repro.bench.dashboard as ref_dashboard
import repro.bench.gate as ref_gate
import repro.bench.history as ref_history
import repro.bench.report as ref_report
import repro_torch.bench as port_bench
import repro_torch.bench.dashboard as port_dashboard
import repro_torch.bench.gate as port_gate
import repro_torch.bench.history as port_history
import repro_torch.bench.report as port_report
import repro_torch.benchmarks.run as port_run

sys.path.append(os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench"))
from _bench_factories import rate, section_payload, verdict, write_payload  # noqa: E402

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_HISTORY = os.path.join(REPO_ROOT, "benchmarks", "history", "perf_history.jsonl")

PKGS = {
    "ref": types.SimpleNamespace(
        bench=ref_bench, history=ref_history, gate=ref_gate, report=ref_report,
        dashboard=ref_dashboard, run=ref_run, legacy_gate=ref_legacy_gate,
        reporting=ref_legacy_reporting),
    "port": types.SimpleNamespace(
        bench=port_bench, history=port_history, gate=port_gate, report=port_report,
        dashboard=port_dashboard, run=port_run, legacy_gate=port_gate,
        reporting=port_bench),
}

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# ---------------------------------------------------------------- factories
def record(b, run_id, measurements, *, ts="2026-08-01", commit="c" * 40):
    return b.bench.RunRecord(
        run_id=run_id, git_commit_hash=commit, git_branch="main",
        run_start_ts=f"{ts}T00:00:00+00:00", run_end_ts=f"{ts}T00:05:00+00:00",
        jax_version="0.4.37", backend="cpu", measurements=measurements,
    ).validate()


def nm(b, section="scaling", leg="d1", name="packed_scaling", params=None,
       updates_per_sec=None, passed=None):
    return b.bench.NormalizedMeasurement(
        section=section, leg=leg, name=name,
        params=dict(params or {"k_per_device": 8}),
        updates_per_sec=updates_per_sec, passed=passed,
    ).validate()


def plain(x):
    """A package-free value of a result (dataclasses to dicts)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {k: plain(v) for k, v in dataclasses.asdict(x).items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    return x


# ------------------------------------------------------------- models cases
@case
def params_key_is_order_free(b, tmp):
    assert b.bench.params_key({"a": 1, "b": (1, 2)}) == b.bench.params_key({"b": (1, 2), "a": 1})
    return b.bench.params_key({"a": 1, "b": (1, 2)})


@case
def params_key_distinguishes_value_types(b, tmp):
    assert b.bench.params_key({"k": 1}) != b.bench.params_key({"k": "1"})
    return [b.bench.params_key({"k": 1}), b.bench.params_key({"k": "1"})]


BAD_MEASUREMENTS = [dict(name=""), dict(name="x", updates_per_sec=-1.0),
                    dict(name="x", updates_per_sec=True), dict(name="x", passed="yes"),
                    dict(name="x", wall_s=-0.1)]


@case
def measurement_rejects_bad_shapes(b, tmp):
    out = []
    for kw in BAD_MEASUREMENTS:
        with pytest.raises(b.bench.ModelError) as e:
            b.bench.Measurement(**kw).validate()
        out.append(str(e.value))
    return out


@case
def measurement_from_payload_collects_extras(b, tmp):
    m = b.bench.Measurement.from_payload(
        {"name": "served_rate", "params": {"k": 8}, "updates_per_sec": 1e6,
         "efficiency": 0.9, "blocked_events": 3})
    assert m.extras == {"efficiency": 0.9, "blocked_events": 3}
    out = m.to_json()
    assert out["efficiency"] == 0.9 and out["updates_per_sec"] == 1e6
    return out


@case
def section_run_requires_section_and_schema_version(b, tmp):
    with pytest.raises(b.bench.ModelError) as e1:
        b.bench.SectionRun.from_payload({"measurements": []})
    bad = section_payload("scaling", [])
    bad["schema_version"] = 99
    with pytest.raises(b.bench.ModelError) as e2:
        b.bench.SectionRun.from_payload(bad)
    return [str(e1.value), str(e2.value)]


@case
def section_run_host_properties(b, tmp):
    run = b.bench.SectionRun.from_payload(
        section_payload("scaling", [rate("r", 1.0)], device_count=8))
    assert run.device_count == 8 and run.jax_version == "0.4.37" and run.backend == "cpu"
    return [run.device_count, run.jax_version, run.backend]


@case
def run_record_roundtrips_through_jsonl(b, tmp):
    rec = record(b, "run-1", [nm(b, updates_per_sec=1e6),
                              nm(b, name="verdict", params={}, passed=True)])
    back = b.bench.RunRecord.from_json(json.loads(rec.to_jsonl()))
    assert back.to_jsonl() == rec.to_jsonl()
    assert back.run_id == "run-1" and back.jax_version == "0.4.37"
    assert back.schema_version == b.bench.HISTORY_SCHEMA_VERSION
    assert [m.key() for m in back.measurements] == [m.key() for m in rec.measurements]
    return back.to_jsonl()


@case
def run_record_rejects_duplicate_keys(b, tmp):
    m = nm(b, updates_per_sec=1e6)
    with pytest.raises(b.bench.ModelError, match="duplicate") as e:
        record(b, "run-1", [m, nm(b, updates_per_sec=2e6)])
    return str(e.value)


@case
def normalized_measurement_key_includes_leg(b, tmp):
    a = nm(b, leg="d1", updates_per_sec=1.0)
    c = nm(b, leg="d8", updates_per_sec=1.0)
    assert a.key() != c.key()
    assert a.key()[:1] + a.key()[2:] == c.key()[:1] + c.key()[2:]
    return [list(a.key()), list(c.key())]


@case
def normalized_measurement_from_json_validates(b, tmp):
    with pytest.raises(b.bench.ModelError) as e:
        b.bench.NormalizedMeasurement.from_json({"section": "", "name": "x"})
    return str(e.value)


# ------------------------------------------------------------ parsers cases
@case
def find_bench_files_recursive_and_skips_report(b, tmp):
    write_payload(tmp / "d1", section_payload("hier", []))
    write_payload(tmp / "d8", section_payload("scaling", []))
    (tmp / "BENCH_report.json").write_text("{}")
    (tmp / "not_bench.json").write_text("{}")
    found = [os.path.basename(p) for p in b.bench.find_bench_files(str(tmp))]
    assert found == ["BENCH_hier.json", "BENCH_scaling.json"]
    return found


@case
def sweep_strict_vs_tolerant(b, tmp):
    write_payload(tmp, section_payload("hier", [rate("r", 1.0)]))
    (tmp / "BENCH_torn.json").write_text("{not json")
    with pytest.raises(b.bench.ModelError):
        b.bench.sweep_section_runs(str(tmp), strict=True)
    runs, problems = b.bench.sweep_section_runs(str(tmp), strict=False)
    assert len(runs) == 1 and len(problems) == 1 and "BENCH_torn.json" in problems[0]
    return [len(runs), problems[0].replace(str(tmp), "<tmp>")]


@case
def normalize_multi_leg_tree(b, tmp):
    write_payload(tmp / "benchmark-json-d1", section_payload(
        "scaling", [rate("packed_scaling", 1e6, k_per_device=8)], device_count=1))
    write_payload(tmp / "benchmark-json-d8", section_payload(
        "scaling", [rate("packed_scaling", 6e6, k_per_device=8)], device_count=8,
        ci_run_id="777"))
    rec, problems = b.bench.normalize_dir(str(tmp))
    assert problems == [] and rec.run_id == "777" and rec.legs() == ("d1", "d8")
    assert len(rec.by_key()) == 2
    assert {m.leg: m.updates_per_sec for m in rec.measurements} == {"d1": 1e6, "d8": 6e6}
    return rec.to_jsonl()


@case
def normalize_later_timestamp_wins_collision(b, tmp):
    write_payload(tmp / "a", section_payload(
        "serve", [rate("served_rate", 1e5, k_per_device=8)], ts="2026-08-01"))
    write_payload(tmp / "b", section_payload(
        "serve", [rate("served_rate", 2e5, k_per_device=8)], ts="2026-08-02"))
    rec, _ = b.bench.normalize_dir(str(tmp))
    assert len(rec.measurements) == 1 and rec.measurements[0].updates_per_sec == 2e5
    return rec.to_jsonl()


@case
def normalize_provenance_first_non_unknown(b, tmp):
    write_payload(tmp, section_payload("hier", [], commit="unknown", branch="unknown"))
    write_payload(tmp, section_payload("scaling", [], commit="a" * 40, ts="2026-08-02"))
    rec, _ = b.bench.normalize_dir(str(tmp))
    assert rec.git_commit_hash == "a" * 40 and rec.run_id == f"local-{'a' * 12}"
    assert rec.run_start_ts.startswith("2026-08-01") and rec.run_end_ts.startswith("2026-08-02")
    return rec.to_jsonl()


@case
def normalize_empty_tree_raises(b, tmp):
    with pytest.raises(b.bench.ModelError, match="no BENCH") as e:
        b.bench.normalize_dir(str(tmp))
    with pytest.raises(b.bench.ModelError):
        b.bench.normalize_run([])
    return str(e.value).replace(str(tmp), "<tmp>")


@case
def leg_label_from_host_not_directory(b, tmp):
    path = write_payload(tmp / "renamed-download-dir", section_payload("hier", [], device_count=8))
    assert b.bench.leg_label(b.bench.parse_section_file(path)) == "d8"
    no_host = section_payload("hier", [])
    del no_host["host"]
    path2 = write_payload(tmp / "x", no_host)
    assert b.bench.leg_label(b.bench.parse_section_file(path2)) == ""
    return "d8"


# every shape the benches emit parses (the reference's list, plus the
# fields the port's sections add to each)
SECTION_SHAPES = {
    "hier_update": [
        rate("hier_2level", 1e6, cuts=[100000], total_edges=80000),
        verdict("verdict_hier_beats_flat", True),
        verdict("verdict_flat_rate_decays", True),
    ],
    "kernels": [
        rate("merge_add", 1e7, n=4096),
        rate("sort_dedup", 1e7, n=4096),
        {"name": "scatter_add", "params": {"V": 1000, "d": 8, "k": 4},
         "wall_s": 1e-3, "dense_equiv_us": 5.0},
    ],
    "embed_grad": [
        rate("embed_grad", 1e6, V=1000, d=8, tokens_per_microbatch=256, micro=4),
    ],
    "scaling": [
        rate("device_scaling", 1e6, n_devices=8, k_per_device=1, n_instances=8),
        rate("packed_scaling", 5e6, k_per_device=64, n_devices=8,
             groups=20, group_size=32, rmat_scale=16),
        verdict("verdict_rate_increases_with_k", True, k_values=[1, 8, 64]),
        verdict("update_path_collectives", True, k_per_device=8, n_devices=8),
        rate("projection_34000_instances", 1.9e9, basis_k=64, basis_devices=8),
    ],
    "cascade_kernel": [
        rate("cascade_step", 2e6, k=8, schedule="0pct", engine="pallas"),
        rate("cascade_step", 1e6, k=1, schedule="0pct", engine="cond"),
        {"name": "lane_skip_speedup", "params": {"k": 8}, "speedup": 3.0,
         "cascades_per_step": 0.0, "passed": True},
    ],
    "serve": [
        rate("raw_engine_rate", 1e6, k_per_device=8, batches=60, batch=256, rmat_scale=14),
        {"name": "served_rate",
         "params": {"k_per_device": 8, "batches": 60, "batch": 256, "rmat_scale": 14},
         "updates_per_sec": 9e5, "wall_s": 0.1, "efficiency": 0.9,
         "records_in": 15360, "records_fed": 15360, "batches_fed": 60,
         "records_dropped": 0, "blocked_events": 0, "malformed": 0},
        rate("socket_rate", 5e5, k_per_device=8, batches=60, batch=256, rmat_scale=14),
        {"name": "feed_efficiency", "params": {"k_per_device": 8, "floor": 0.5},
         "passed": True, "efficiency": {"1": 0.8, "8": 0.9}},
    ],
}


def _shape_case(section):
    def run(b, tmp):
        path = write_payload(tmp, section_payload(section, SECTION_SHAPES[section]))
        parsed = b.bench.parse_section_file(path)
        assert parsed.section == section
        assert len(parsed.measurements) == len(SECTION_SHAPES[section])
        rec = b.bench.normalize_run([parsed])
        assert len(rec.measurements) == len(SECTION_SHAPES[section])
        return rec.to_jsonl()
    return run


for _section in sorted(SECTION_SHAPES):
    CASES[f"every_emitted_section_shape_parses[{_section}]"] = _shape_case(_section)


@case
def committed_seed_artifact_parses(b, tmp):
    run = b.bench.parse_section_file(os.path.join(REPO_ROOT, "BENCH_scaling.json"))
    assert run.section == "scaling" and run.device_count == 8
    assert b.bench.leg_label(run) == "d8"
    rec = b.bench.normalize_run([run])
    names = {m.name for m in rec.measurements}
    assert {"device_scaling", "packed_scaling", "verdict_rate_increases_with_k"} <= names
    assert len([m for m in rec.measurements if m.updates_per_sec is not None]) >= 5
    return rec.to_jsonl()


# ------------------------------------------------------------ history cases
@case
def append_and_load_roundtrip(b, tmp):
    hist = str(tmp / "perf_history.jsonl")
    b.bench.append_run(record(b, "run-1", [nm(b, updates_per_sec=1e6)], ts="2026-08-01"), hist)
    b.bench.append_run(record(b, "run-2", [nm(b, updates_per_sec=2e6)], ts="2026-08-02"), hist)
    records, problems = b.bench.load_history(hist)
    assert problems == [] and [r.run_id for r in records] == ["run-1", "run-2"]
    assert records[1].measurements[0].updates_per_sec == 2e6
    return open(hist).read()


@case
def missing_history_is_empty_not_error(b, tmp):
    records, problems = b.bench.load_history(str(tmp / "nope.jsonl"))
    assert records == [] and problems == []
    return [records, problems]


@case
def corrupt_line_tolerated_and_reported(b, tmp):
    hist = tmp / "perf_history.jsonl"
    b.bench.append_run(record(b, "run-1", [nm(b, updates_per_sec=1e6)]), str(hist))
    with open(hist, "a") as f:
        f.write("{torn line\n")
    b.bench.append_run(record(b, "run-2", [nm(b, updates_per_sec=2e6)]), str(hist))
    records, problems = b.bench.load_history(str(hist))
    assert [r.run_id for r in records] == ["run-1", "run-2"]
    assert len(problems) == 1 and ":2:" in problems[0]
    with pytest.raises(b.bench.ModelError):
        b.bench.load_history(str(hist), strict=True)
    return [p.replace(str(tmp), "<tmp>") for p in problems]


@case
def append_fresh_artifacts_idempotent_per_run_id(b, tmp):
    write_payload(tmp / "fresh", section_payload(
        "scaling", [rate("packed_scaling", 1e6, k_per_device=8)], ci_run_id="4242"))
    hist = str(tmp / "perf_history.jsonl")
    b.bench.append_fresh_artifacts(str(tmp / "fresh"), hist)
    b.bench.append_fresh_artifacts(str(tmp / "fresh"), hist)
    records, _ = b.bench.load_history(hist)
    assert len(records) == 1 and records[0].run_id == "4242"
    b.bench.append_fresh_artifacts(str(tmp / "fresh"), hist, dedupe_run_id=False)
    records, _ = b.bench.load_history(hist)
    assert len(records) == 2
    return open(hist).read()


@case
def history_lines_are_sorted_json(b, tmp):
    hist = str(tmp / "perf_history.jsonl")
    b.bench.append_run(record(b, "run-1", [nm(b, updates_per_sec=1e6)]), hist)
    line = open(hist).read().strip()
    assert line == json.dumps(json.loads(line), sort_keys=True)
    return line


@case
def cli_append_and_show(b, tmp, capsys):
    write_payload(tmp / "fresh", section_payload(
        "serve", [rate("served_rate", 9e5, k_per_device=8)]))
    hist = str(tmp / "perf_history.jsonl")
    rc1 = b.history.main(["append", "--fresh", str(tmp / "fresh"), "--history", hist,
                          "--run-id", "test-run"])
    out1 = capsys.readouterr().out
    assert rc1 == 0 and "history,appended,run_id=test-run" in out1 and "sections=serve" in out1
    rc2 = b.history.main(["show", "--history", hist])
    out2 = capsys.readouterr().out
    assert rc2 == 0 and "history,1 run(s)" in out2 and "run_id=test-run" in out2
    return [rc1, rc2, (out1 + out2).replace(str(tmp), "<tmp>")]


@case
def cli_append_empty_tree_errors(b, tmp, capsys):
    rc = b.history.main(["append", "--fresh", str(tmp / "empty"),
                         "--history", str(tmp / "h.jsonl")])
    out = capsys.readouterr().out
    assert rc == 1 and "history,error" in out
    return [rc, out.replace(str(tmp), "<tmp>")]


# --------------------------------------------------------------- gate cases
def _history(b, rates, name="packed_scaling", passed_series=()):
    runs = [record(b, f"run-{i}", [nm(b, updates_per_sec=r, name=name)], ts=f"2026-07-{i + 1:02d}")
            for i, r in enumerate(rates)]
    runs += [record(b, f"verdict-run-{i}", [nm(b, name="verdict", params={}, passed=p)],
                    ts=f"2026-08-{i + 1:02d}")
             for i, p in enumerate(passed_series)]
    return runs


def _fresh(b, rate_value=None, name="packed_scaling", passed=None):
    ms = []
    if rate_value is not None:
        ms.append(nm(b, updates_per_sec=rate_value, name=name))
    if passed is not None:
        ms.append(nm(b, name="verdict", params={}, passed=passed))
    return record(b, "fresh", ms, ts="2026-08-09")


@case
def noisy_but_flat_trend_passes(b, tmp):
    result = b.bench.gate_run(_fresh(b, 0.95e6), _history(b, [1.00e6, 0.94e6, 1.06e6, 0.97e6, 1.03e6]))
    assert result.passed and result.warned == [] and result.compared == 1
    assert result.findings[0].tag == "ok"
    return plain(result)


@case
def step_regression_fails(b, tmp):
    result = b.bench.gate_run(_fresh(b, 0.6e6), _history(b, [1.0e6, 1.02e6, 0.98e6, 1.01e6, 0.99e6]))
    assert not result.passed
    assert result.failed[0].label.startswith("scaling/packed_scaling@d1")
    return plain(result)


@case
def single_outlier_run_absorbed_by_median(b, tmp):
    history = _history(b, [1.0e6, 1.01e6, 0.99e6, 1.02e6, 0.5e6])
    r1 = b.bench.gate_run(_fresh(b, 1.0e6), history)
    assert r1.passed and r1.warned == []
    r2 = b.bench.gate_run(_fresh(b, 0.6e6), history)
    assert not r2.passed
    return [plain(r1), plain(r2)]


@case
def warn_band_between_thresholds(b, tmp):
    result = b.bench.gate_run(_fresh(b, 0.85e6), _history(b, [1.0e6] * 5))
    assert result.passed and len(result.warned) == 1 and result.warned[0].tag == "WARN"
    return plain(result)


@case
def window_limits_how_far_back_the_trend_looks(b, tmp):
    history = _history(b, [2.0e6] * 10 + [1.0e6] * 5)
    r1 = b.bench.gate_run(_fresh(b, 0.95e6), history, window=5)
    assert r1.passed and r1.warned == []
    r2 = b.bench.gate_run(_fresh(b, 0.95e6), history, window=15)
    assert not r2.passed
    return [plain(r1), plain(r2)]


@case
def verdict_true_to_false_trips(b, tmp):
    result = b.bench.gate_run(_fresh(b, passed=False), _history(b, [], passed_series=[True] * 3))
    assert not result.passed
    assert "verdict regressed true -> false" in result.failed[0].detail
    return plain(result)


@case
def verdict_false_history_does_not_trip(b, tmp):
    result = b.bench.gate_run(_fresh(b, passed=False),
                              _history(b, [], passed_series=[False, False, True]))
    assert result.passed
    return plain(result)


@case
def empty_history_is_baseline_established(b, tmp):
    result = b.bench.gate_run(_fresh(b, 1.0e6), [])
    assert result.baseline_established and result.passed and result.compared == 0
    return plain(result)


@case
def new_key_is_informational_not_blocking(b, tmp):
    fresh = record(b, "fresh", [nm(b, updates_per_sec=1.0e6),
                                nm(b, name="brand_new_bench", updates_per_sec=5.0)],
                   ts="2026-08-09")
    result = b.bench.gate_run(fresh, _history(b, [1.0e6] * 3))
    assert result.passed and result.new == 1 and result.compared == 1
    return plain(result)


@case
def gate_cli_history_mode(b, tmp, capsys):
    hist = tmp / "perf_history.jsonl"
    for r in _history(b, [1.0e6] * 5):
        b.history.append_run(r, str(hist))
    write_payload(tmp / "fresh", section_payload(
        "scaling", [rate("packed_scaling", 0.5e6, k_per_device=8)]))
    rc = b.gate.main(["--fresh", str(tmp / "fresh"), "--history", str(hist)])
    out = capsys.readouterr().out
    assert rc == 1 and "gate,history,5 run(s)" in out
    assert "gate,FAIL" in out and "gate,verdict,FAIL" in out
    return [rc, out.replace(str(tmp), "<tmp>")]


@case
def gate_cli_missing_history_file_is_baseline_established(b, tmp, capsys):
    write_payload(tmp / "fresh", section_payload(
        "scaling", [rate("packed_scaling", 1.0e6, k_per_device=8)]))
    rc = b.gate.main(["--fresh", str(tmp / "fresh"), "--history", str(tmp / "none.jsonl")])
    out = capsys.readouterr().out
    assert rc == 0 and "baseline-established" in out and "gate,verdict,PASS" in out
    return [rc, out.replace(str(tmp), "<tmp>")]


@case
def gate_cli_verdict_regression_via_history(b, tmp, capsys):
    hist = tmp / "perf_history.jsonl"
    for i in range(3):
        b.history.append_run(record(
            b, f"run-{i}", [nm(b, name="feed_efficiency", params={"floor": 0.5}, passed=True)],
            ts=f"2026-08-0{i + 1}"), str(hist))
    write_payload(tmp / "fresh", section_payload(
        "scaling", [verdict("feed_efficiency", False, floor=0.5)]))
    rc = b.gate.main(["--fresh", str(tmp / "fresh"), "--history", str(hist)])
    out = capsys.readouterr().out
    assert rc == 1 and "verdict regressed" in out
    return [rc, out.replace(str(tmp), "<tmp>")]


# ---------------------------------------------------------- dashboard cases
def _dash_runs(b):
    return [
        record(b, "r1", [nm(b, name="leg_rate", params={"k_per_device": 8}, updates_per_sec=100.0)]),
        record(b, "r2", [nm(b, name="leg_rate", params={"k_per_device": 8}, updates_per_sec=150.0)],
               ts="2026-08-02"),
    ]


@case
def render_contains_series_and_sparkline(b, tmp):
    html = b.dashboard.render_dashboard(b.report.report_payload(_dash_runs(b)))
    assert "<svg" in html and "polyline" in html and "leg_rate" in html
    assert "2 run(s)" in html and "150" in html
    return html


@case
def jax_version_change_marked(b, tmp):
    runs = _dash_runs(b)
    runs[1].jax_version = "0.5.0"
    runs[0].jax_version = "0.4.37"
    html = b.dashboard.render_dashboard(b.report.report_payload(runs))
    assert "jax 0.4.37 -&gt; 0.5.0" in html or "jax 0.4.37 -> 0.5.0" in html
    return html


@case
def no_marker_when_version_stable(b, tmp):
    html = b.dashboard.render_dashboard(b.report.report_payload(_dash_runs(b)))
    assert 'fill="#d95f0e"' not in html
    return html


@case
def single_point_series_renders(b, tmp):
    html = b.dashboard.render_dashboard(b.report.report_payload(_dash_runs(b)[:1]))
    assert "<svg" in html
    return html


@case
def empty_payload_renders_placeholder(b, tmp):
    html = b.dashboard.render_dashboard(
        {"schema_version": 1, "n_runs": 0, "window": 5, "series": []})
    assert "no rate measurements" in html
    return html


@case
def dashboard_write_and_cli_round_trip(b, tmp):
    payload = b.report.report_payload(_dash_runs(b))
    report_path = tmp / "BENCH_report.json"
    report_path.write_text(json.dumps(payload))
    out = tmp / "sub" / "dashboard.html"
    assert b.dashboard.main(["--report", str(report_path), "--out", str(out)]) == 0
    html = out.read_text()
    assert html == b.dashboard.render_dashboard(payload)
    assert b.dashboard.write_dashboard(payload, str(out)) == str(out)
    return html


# --------------------------------------------------------- experiments cases
@case
def sections_tuple_matches_run_py(b, tmp):
    assert b.run.SECTIONS == b.bench.SECTIONS == (
        "hier", "kernels", "embed", "scaling", "cascade_kernel", "serve",
        "fleet", "query", "obs",
    )
    return list(b.bench.SECTIONS)


def _legs(spec):
    return [(leg.section, leg.label, leg.kwargs()) for leg in spec.legs]


@case
def from_dict_defaults_merge_under_leg_params(b, tmp):
    spec = b.bench.ExperimentSpec.from_dict({
        "name": "x", "defaults": {"smoke": True, "batch": 128},
        "legs": [{"section": "serve", "params": {"batch": 256}}]})
    assert spec.legs[0].kwargs() == {"smoke": True, "batch": 256}
    return _legs(spec)


@case
def matrix_cross_product_expands_legs(b, tmp):
    spec = b.bench.ExperimentSpec.from_dict({"name": "sweep", "legs": [
        {"section": "serve", "matrix": {"batch": [128, 256], "scale": [14, 16]}}]})
    assert len(spec.legs) == 4 and len({l.label for l in spec.legs}) == 4
    combos = {(l.kwargs()["batch"], l.kwargs()["scale"]) for l in spec.legs}
    assert combos == {(128, 14), (128, 16), (256, 14), (256, 16)}
    return _legs(spec)


@case
def lists_freeze_to_tuples_for_hashable_legs(b, tmp):
    spec = b.bench.ExperimentSpec.from_dict(
        {"name": "x", "legs": [{"section": "scaling", "params": {"k_values": [1, 8]}}]})
    assert spec.legs[0].kwargs()["k_values"] == (1, 8)
    hash(spec.legs[0])
    return _legs(spec)


MALFORMED = [
    ({"name": "x"}, "legs"),
    ({"name": "x", "legs": []}, "legs"),
    ({"name": "x", "legs": [{"section": "warp"}]}, "unknown section"),
    ({"name": "x", "legs": [{"section": "hier", "bogus": 1}]}, "unknown keys"),
    ({"name": "x", "typo_key": 1, "legs": [{"section": "hier"}]}, "unknown top-level"),
    ({"name": "x", "legs": [{"section": "hier", "matrix": {"k": []}}]}, "non-empty list"),
]


def _malformed_case(payload, match):
    def run(b, tmp):
        with pytest.raises(b.bench.ExperimentError, match=match) as e:
            b.bench.ExperimentSpec.from_dict(payload)
        return str(e.value)
    return run


for _i, (_payload, _match) in enumerate(MALFORMED):
    CASES[f"from_dict_rejects_malformed[{_i}]"] = _malformed_case(_payload, _match)


@case
def from_file_json(b, tmp):
    path = tmp / "exp.json"
    path.write_text(json.dumps({"name": "file-exp", "legs": [{"section": "hier"}]}))
    spec = b.bench.ExperimentSpec.from_file(str(path))
    assert spec.name == "file-exp" and spec.source == str(path)
    return _legs(spec)


@case
def from_file_unreadable(b, tmp):
    with pytest.raises(b.bench.ExperimentError, match="unreadable") as e:
        b.bench.ExperimentSpec.from_file(str(tmp / "nope.json"))
    return str(e.value).replace(str(tmp), "<tmp>")


@case
def committed_ci_configs_parse_and_validate(b, tmp):
    """The reference's committed configs load in both packages and pass
    signature validation against each package's own sections."""
    out = []
    for cfg in ("ci-smoke.json", "ci-smoke-d8.json", "serve-sweep.json", "fleet_smoke.json",
                "obs_smoke.json", "query_smoke.json"):
        spec = b.bench.ExperimentSpec.from_file(os.path.join(REPO_ROOT, "benchmarks", "experiments", cfg))
        for leg in spec.legs:
            b.bench.validate_leg_params(leg)
        out.append(_legs(spec))
    return out


@case
def validate_leg_params_rejects_typo(b, tmp):
    spec = b.bench.ExperimentSpec.from_dict(
        {"name": "x", "legs": [{"section": "serve", "params": {"nope": 1}}]})
    with pytest.raises(b.bench.ExperimentError, match="does not accept") as e:
        b.bench.validate_leg_params(spec.legs[0])
    return str(e.value).split("; accepted")[0]


@case
def validate_leg_params_accepts_real_signatures(b, tmp):
    spec = b.bench.ExperimentSpec.from_dict(
        {"name": "all", "legs": [{"section": s, "params": {"smoke": True}}
                                 for s in b.bench.SECTIONS if s not in ("hier", "scaling")]
         + [{"section": "hier", "params": {"total_edges": 80_000, "group_size": 2_000,
                                           "scale": 14}},
            {"section": "scaling", "params": {"k_values": [1, 8], "groups": 5,
                                              "device_sweep": False}}]})
    for leg in spec.legs:
        b.bench.validate_leg_params(leg)
    return _legs(spec)


# ------------------------------------------------------------- report cases
@case
def dims_from_params_and_leg(b, tmp):
    m = nm(b, params={"k_per_device": 64, "n_devices": 8}, updates_per_sec=1.0)
    assert b.bench.measurement_dims(m) == {"engine": "mesh", "k": 64, "d": 8, "source": "rmat"}
    m2 = nm(b, leg="d8", params={"k_per_device": 8}, updates_per_sec=1.0)
    assert b.bench.measurement_dims(m2)["d"] == 8
    return [b.bench.measurement_dims(m), b.bench.measurement_dims(m2)]


@case
def dims_serve_engine_and_source(b, tmp):
    raw = nm(b, section="serve", name="raw_engine_rate", params={"k_per_device": 1},
             updates_per_sec=1.0)
    served = nm(b, section="serve", name="served_rate", params={"k_per_device": 8},
                updates_per_sec=1.0)
    sock = nm(b, section="serve", name="socket_rate", params={"k_per_device": 8},
              updates_per_sec=1.0)
    dims = [b.bench.measurement_dims(x) for x in (raw, served, sock)]
    assert dims[0] == {"engine": "single", "k": 1, "d": 1, "source": "preroute"}
    assert dims[1]["engine"] == "packed" and dims[1]["source"] == "array"
    assert dims[2]["source"] == "tcp"
    return dims


@case
def dims_section_fallbacks_use_real_emitted_names(b, tmp):
    hier = nm(b, section="hier_update", name="2cut_wide", params={"cuts": (8000, 20000)},
              updates_per_sec=1.0)
    embed = nm(b, section="embed_grad", name="embed_grad", params={"V": 1000},
               updates_per_sec=1.0)
    dims = [b.bench.measurement_dims(hier), b.bench.measurement_dims(embed)]
    assert dims[0] == {"engine": "single", "k": 1, "d": 1, "source": "rmat"}
    assert dims[1]["engine"] == "single" and dims[1]["source"] == "tokens"
    return dims


@case
def dims_explicit_engine_param_wins(b, tmp):
    m = nm(b, section="cascade_kernel", name="cascade_step",
           params={"k": 8, "engine": "pallas", "schedule": "0pct"}, updates_per_sec=1.0)
    d = b.bench.measurement_dims(m)
    assert d["engine"] == "pallas" and d["k"] == 8 and d["source"] == "synthetic"
    return d


def _two_runs(b):
    return [record(b, "run-1", [nm(b, updates_per_sec=1.0e6)], ts="2026-08-01"),
            record(b, "run-2", [nm(b, updates_per_sec=1.2e6)], ts="2026-08-02")]


@case
def build_series_collects_points_across_runs(b, tmp):
    (s,) = b.bench.build_series(_two_runs(b))
    assert [p["updates_per_sec"] for p in s.points] == [1.0e6, 1.2e6]
    assert [p["run_id"] for p in s.points] == ["run-1", "run-2"]
    assert s.latest() == 1.2e6 and s.points[0]["jax_version"] == "0.4.37"
    return plain(s)


@case
def report_payload_shape(b, tmp):
    payload = b.bench.report_payload(_two_runs(b))
    assert payload["schema_version"] == 1 and payload["n_runs"] == 2
    (entry,) = payload["series"]
    assert {"engine", "k", "d", "source"} <= set(entry)
    assert entry["n_runs"] == 2 and entry["latest_updates_per_sec"] == 1.2e6
    assert entry["best_updates_per_sec"] == 1.2e6
    return payload


@case
def markdown_table_has_dimension_columns(b, tmp):
    md = b.bench.report_markdown(_two_runs(b))
    assert "| measurement | engine | K | D | source |" in md
    assert "scaling/packed_scaling@d1" in md
    return md


@case
def write_report_emits_json_and_md(b, tmp):
    json_path, md_path = b.bench.write_report(_two_runs(b), str(tmp))
    assert os.path.basename(json_path) == "BENCH_report.json"
    payload = json.load(open(json_path))
    assert payload["n_runs"] == 2
    md = open(md_path).read()
    assert "# Benchmark rate trajectory" in md
    return [payload, md]


@case
def report_from_committed_seed_plus_fresh_artifacts(b, tmp, capsys):
    write_payload(tmp / "fresh", section_payload(
        "scaling",
        [rate("packed_scaling", 5.5e6, k_per_device=64, n_devices=8, n_instances=512,
              groups=20, group_size=32, rmat_scale=16),
         rate("device_scaling", 1.1e6, n_devices=8, k_per_device=1, n_instances=8)],
        device_count=8, ci_run_id="999", ts="2026-08-09"))
    rc = b.report.main(["--history", SEED_HISTORY, "--fresh", str(tmp / "fresh"),
                        "--out", str(tmp / "report")])
    assert rc == 0 and "report,written,runs=2" in capsys.readouterr().out
    payload = json.load(open(tmp / "report" / "BENCH_report.json"))
    assert payload["n_runs"] == 2
    two_point = [s for s in payload["series"] if s["n_runs"] == 2]
    assert {(s["section"], s["name"]) for s in two_point} == {
        ("scaling", "packed_scaling"), ("scaling", "device_scaling")}
    for s in two_point:
        assert s["engine"] == "mesh" and s["d"] == 8 and s["points"][-1]["run_id"] == "999"
    assert any(s["n_runs"] == 1 for s in payload["series"])
    return [payload, open(tmp / "report" / "BENCH_report.md").read()]


# ------------------------------------------------- legacy regression gate
def _write_bench(dir_path, section, measurements):
    os.makedirs(dir_path, exist_ok=True)
    with open(os.path.join(dir_path, f"BENCH_{section}.json"), "w") as f:
        json.dump({"schema_version": 1, "section": section, "git_commit_hash": "deadbeef",
                   "git_branch": "test", "measurements": measurements}, f)


def _legacy(b, tmp, capsys, argv):
    rc = b.legacy_gate.main(argv)
    return [rc, capsys.readouterr().out.replace(str(tmp), "<tmp>")]


@case
def legacy_missing_baseline_is_clean_pass(b, tmp, capsys):
    _write_bench(tmp / "fresh", "scaling", [rate("packed_rate", 1e6, k=8)])
    rc, out = _legacy(b, tmp, capsys, ["--baseline", str(tmp / "nope"), "--fresh", str(tmp / "fresh")])
    assert rc == 0 and "baseline-established" in out and "gate,verdict,PASS" in out
    return [rc, out]


@case
def legacy_empty_baseline_dir_is_clean_pass(b, tmp, capsys):
    (tmp / "base").mkdir()
    _write_bench(tmp / "fresh", "scaling", [rate("packed_rate", 1e6, k=8)])
    rc, out = _legacy(b, tmp, capsys, ["--baseline", str(tmp / "base"), "--fresh", str(tmp / "fresh")])
    assert rc == 0 and "baseline-established" in out
    return [rc, out]


@case
def legacy_unreadable_baseline_json_is_clean_pass(b, tmp, capsys):
    (tmp / "base").mkdir()
    (tmp / "base" / "BENCH_broken.json").write_text("{not json")
    _write_bench(tmp / "fresh", "scaling", [rate("packed_rate", 1e6, k=8)])
    rc, out = _legacy(b, tmp, capsys, ["--baseline", str(tmp / "base"), "--fresh", str(tmp / "fresh")])
    assert rc == 0 and "baseline-established" in out
    return [rc, out]


@case
def legacy_missing_fresh_is_still_an_error(b, tmp, capsys):
    rc, out = _legacy(b, tmp, capsys, ["--baseline", str(tmp), "--fresh", str(tmp / "nope")])
    assert rc == 1 and "gate,error" in out
    return [rc, out]


@case
def legacy_rate_regression_trips_gate(b, tmp, capsys):
    _write_bench(tmp / "base", "scaling", [rate("packed_rate", 1e6, k=8)])
    _write_bench(tmp / "fresh", "scaling", [rate("packed_rate", 0.5e6, k=8)])
    rc, out = _legacy(b, tmp, capsys, ["--baseline", str(tmp / "base"), "--fresh", str(tmp / "fresh")])
    assert rc == 1 and "gate,FAIL" in out
    return [rc, out]


@case
def legacy_small_drop_warns_but_passes(b, tmp, capsys):
    _write_bench(tmp / "base", "scaling", [rate("packed_rate", 1e6, k=8)])
    _write_bench(tmp / "fresh", "scaling", [rate("packed_rate", 0.85e6, k=8)])
    rc, out = _legacy(b, tmp, capsys, ["--baseline", str(tmp / "base"), "--fresh", str(tmp / "fresh")])
    assert rc == 0 and "gate,WARN" in out
    return [rc, out]


@case
def legacy_cascade_kernel_section_covered_automatically(b, tmp, capsys):
    _write_bench(tmp / "base", "cascade_kernel", [
        rate("cascade_step", 2e6, k=8, schedule="0pct", engine="pallas"),
        verdict("lane_skip_speedup", True, k=8)])
    _write_bench(tmp / "fresh", "cascade_kernel", [
        rate("cascade_step", 2.1e6, k=8, schedule="0pct", engine="pallas"),
        verdict("lane_skip_speedup", False, k=8)])
    rc, out = _legacy(b, tmp, capsys, ["--baseline", str(tmp / "base"), "--fresh", str(tmp / "fresh")])
    assert rc == 1 and "verdict regressed" in out
    assert "cascade_kernel/lane_skip_speedup" in out and "compared=2" in out
    return [rc, out]


@case
def legacy_cascade_kernel_keys_roundtrip_reporting_schema(b, tmp):
    rep = b.reporting.BenchmarkReport("cascade_kernel")
    rep.add("cascade_step", params={"k": 1, "schedule": "0pct", "engine": "pallas"},
            updates_per_sec=1e6, wall_s=1e-3)
    rep.add("lane_skip_speedup", params={"k": 1}, speedup=3.0, passed=True)
    path = rep.write(str(tmp))
    assert os.path.basename(path) == "BENCH_cascade_kernel.json"
    loaded = b.legacy_gate.load_measurements(str(tmp))
    keys = sorted({k[:2] for k in loaded})
    assert keys == [("cascade_kernel", "cascade_step"), ("cascade_kernel", "lane_skip_speedup")]
    return [list(k) for k in keys]


@case
def legacy_ci_run_id_in_payload(b, tmp, monkeypatch):
    monkeypatch.setenv("GITHUB_RUN_ID", "424242")
    rep = b.reporting.BenchmarkReport("cascade_kernel")
    rep.add("cascade_step", params={"k": 1}, updates_per_sec=1.0)
    assert rep.payload()["ci_run_id"] == "424242"
    monkeypatch.delenv("GITHUB_RUN_ID")
    assert "ci_run_id" not in rep.payload()
    return rep.payload()["measurements"]


# ------------------------------------------------------ the parity test
@pytest.mark.parametrize("name", sorted(CASES))
def test_port_matches_reference(name, tmp_path, capsys, monkeypatch):
    fn = CASES[name]
    extra = fn.__code__.co_varnames[2:fn.__code__.co_argcount]
    results = {}
    for pkg, b in PKGS.items():
        d = tmp_path / pkg
        d.mkdir()
        kwargs = {"capsys": capsys, "monkeypatch": monkeypatch}
        results[pkg] = fn(b, d, **{k: kwargs[k] for k in extra})
    assert results["port"] == results["ref"], name


# ----------------------------------------------------- the port's own parts
def test_port_host_info_names_the_device_and_no_jax(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.delenv("BENCH_JSON_DIR", raising=False)
    rep = port_bench.BenchmarkReport("scaling", device="cpu")
    rep.add("packed_scaling", params={"k_per_device": 8}, updates_per_sec=1.0)
    path = rep.write()
    assert os.path.relpath(path, tmp_path) == os.path.join("bench-artifacts", "torch",
                                                           "BENCH_scaling.json")
    host = json.load(open(path))["host"]
    assert host["backend"] == "cpu" and host["device_count"] == 1
    assert host["torch_version"] and "jax_version" not in host
    # the reference's parsers read it: a cpu leg d1, no jax version
    run = ref_bench.parse_section_file(path)
    assert ref_bench.leg_label(run) == "d1" and run.jax_version is None


def test_port_history_is_its_own_file():
    path = port_bench.default_history_path()
    assert path == os.path.join(REPO_ROOT, port_bench.DEFAULT_HISTORY_RELPATH)
    assert path.endswith(os.path.join("src", "repro_torch", "benchmarks", "history",
                                      "perf_history.jsonl"))
    assert path != ref_bench.default_history_path()


def test_port_gate_defaults_to_its_own_history(tmp_path, capsys, monkeypatch):
    """Without ``--history`` the port's gate reads the port's history file;
    where it is absent, that is a clean baseline-established pass (the
    reference's history would have failed this fresh run)."""
    monkeypatch.setattr(port_gate, "default_history_path",
                        lambda: str(tmp_path / "absent.jsonl"))
    write_payload(tmp_path / "fresh", section_payload(
        "scaling", [rate("packed_scaling", 1.0, k_per_device=8)]))
    assert port_gate.main(["--fresh", str(tmp_path / "fresh")]) == 0
    assert "baseline-established" in capsys.readouterr().out


@pytest.mark.parametrize("spec", ["chip.json", "ci-smoke.json"])
def test_port_committed_specs_validate(spec):
    path = os.path.join(REPO_ROOT, "src", "repro_torch", "benchmarks", "experiments", spec)
    loaded = port_bench.ExperimentSpec.from_file(path)
    for leg in loaded.legs:
        port_bench.validate_leg_params(leg)
        if leg.section == "scaling":
            assert leg.kwargs()["device_sweep"] is False


def test_run_spec_passes_the_device(monkeypatch):
    seen = []
    monkeypatch.setattr(port_bench.experiments, "_section_main",
                        lambda section: lambda **kw: seen.append((section, kw)))
    spec = port_bench.ExperimentSpec.from_dict(
        {"name": "x", "legs": [{"section": "kernels", "params": {"smoke": True,
                                                                  "device": "cuda"}}]})
    monkeypatch.setattr(port_bench.experiments, "validate_leg_params", lambda leg: None)
    port_bench.run_spec(spec, device="cpu")
    port_bench.run_spec(spec)
    assert seen == [("kernels", {"smoke": True, "device": "cpu"}),
                    ("kernels", {"smoke": True, "device": "cuda"})]


def test_run_without_cuda_raises(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_run.main(["--experiment", os.path.join(REPO_ROOT, "benchmarks", "experiments",
                                                    "ci-smoke.json")])
