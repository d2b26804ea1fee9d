"""The yardstick on the CPU: BENCHMARK.json resolves to its files, the plain
reference against brute force, the tail statistic, the roofline byte
counts, the trace reduction, and what the benchmark loads."""
import json
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from conftest import ROOT
from d4m_bench import harness, reference, roofline, stream, trace

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("workload", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves_to_its_files(workload):
    cell = harness.load_cell(workload)
    assert cell.config["name"] == cell.workload["config"]
    assert cell.traffic["name"] == cell.workload["traffic"]
    names = {m["name"] for m in cell.metrics}
    assert "setup_s" in names
    assert any(m["kind"] == "per_layer" for m in cell.metrics)
    assert any(m["kind"] == "end_to_end" and m["name"] != "setup_s" for m in cell.metrics)
    for m in cell.metrics:
        assert callable(harness.reader(m["name"]))


@pytest.mark.parametrize("change,message", [
    (dict(loop="open"), "no loop 'open'"),
    (dict(queries=[{"op": "row", "row": 7}]), "no op 'row'"),
    (dict(generator="uniform"), "the one generator"),
    (dict(query_every_groups=0), "go together"),
    (dict(epoch_groups=2000), "cannot hold a view"),
])
def test_a_cell_asking_for_what_the_benchmark_lacks_is_refused(change, message):
    cell = harness.load_cell("rmat20_k1_query")
    cell.traffic = dict(cell.traffic, **change)
    with pytest.raises(ValueError, match=message):
        harness.check(cell)


def test_every_file_named_by_the_spec_exists_and_every_config_is_used():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert c["name"] in used
        assert (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["source"] == c["source"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert (ROOT / "d4m_bench" / "metrics" / f"{m['name']}.py").is_file()


def _brute(src, dst, vals):
    counts = {}
    for s, d, v in zip(src.tolist(), dst.tolist(), vals.tolist()):
        counts[(s, d)] = counts.get((s, d), 0.0) + v
    return counts


def test_reference_sums_match_brute_force():
    traffic = dict(scale=5, a=0.57, b=0.19, c=0.19, weight=1.0, group_size=64, epoch_groups=6)
    src, dst, vals = stream.epoch(traffic, 3, "cpu")
    keys, sums = reference.key_sums(src, dst, vals)
    want = _brute(src.reshape(-1), dst.reshape(-1), vals.reshape(-1))
    got = {(int(k) >> 32, int(k) & 0xFFFFFFFF): float(v) for k, v in zip(keys, sums)}
    assert got == want
    assert max(want.values()) > 1  # the stream repeats keys
    assert reference.compare_sums(keys, sums, keys, sums) == {"keys_wrong": 0.0, "value_err": 0.0}
    bad = sums.clone()
    bad[0] += 2
    assert reference.compare_sums(keys, bad, keys, sums)["value_err"] == 2.0
    assert reference.compare_sums(keys[1:], sums[1:], keys, sums)["keys_wrong"] == 1.0


def test_top_k_check_accepts_any_vertex_tied_at_the_kth_place():
    deg = torch.tensor([5.0, 3.0, 3.0, 3.0, 1.0, 0.0], dtype=torch.float64)
    src = torch.repeat_interleave(torch.arange(6), deg.to(torch.int64))
    assert torch.equal(reference.out_degrees(src, torch.ones(src.numel()), 6), deg)
    for tied in (1, 2, 3):
        assert not reference.top_k_wrong(deg, [0, tied], [5.0, 3.0], 2)
    assert reference.top_k_wrong(deg, [0, 4], [5.0, 1.0], 2)  # not among the heaviest
    assert reference.top_k_wrong(deg, [0, 1], [5.0, 4.0], 2)  # a count altered
    assert reference.top_k_wrong(deg, [1, 1], [3.0, 3.0], 2)  # a vertex twice, and the top missing
    assert reference.top_k_wrong(deg, [0, 2], [5.0, 2.0], 2)


def test_query_p95_is_taken_over_every_sample():
    read = harness.reader("query_p95_ms")
    base = [0.010] * 100
    rec = SimpleNamespace(latencies_s=base)
    assert read(rec) == pytest.approx(10.0)
    # a stall of six queries (beyond 95 of 100 samples) moves the tail
    rec = SimpleNamespace(latencies_s=base[:94] + [0.5] * 6)
    assert read(rec) == pytest.approx(500.0)
    assert read(SimpleNamespace(latencies_s=[])) is None


def test_roofline_bytes_are_the_hand_counted_lower_bound():
    # 1,000 updates of 12-byte entries, read once; two cascades out of layer 1
    # (cut 100) and one out of layer 2 (cut 1,000), each moving at least
    # the cut's entries, read once and written once
    assert roofline.update_bytes(1000, [0, 2, 1], [100, 1000], 4) == 12 * (1000 + 2 * (2 * 100 + 1 * 1000))
    assert roofline.snapshot_bytes(700, 500, 4) == 12 * 1200
    assert roofline.entry_bytes(2) == 10
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert roofline.peak_bytes_per_s("cpu") is None


class _Ev:
    def __init__(self, name, t0, t1, cuda, annotation=False, tid=1):
        self._v = (name, t0, t1, cuda, annotation, tid)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return "cuda" if self._v[3] else "cpu"

    def is_user_annotation(self):
        return self._v[4]

    def start_thread_id(self):
        return self._v[5]


def test_trace_attributes_device_ops_between_their_range_markers():
    mk = "at::cuda::spin_kernel(long)"
    ev = [
        _Ev("window", 0, 1000, False, True),
        _Ev("ingest", 10, 400, False, True), _Ev("route", 20, 200, False, True),
        _Ev("aten::sort", 145, 155, False),
        # device: ingest( route( a b ) c ) then d outside every range
        _Ev(mk, 100, 101, True), _Ev(mk, 102, 103, True),
        _Ev("a", 110, 130, True), _Ev("b", 140, 150, True),
        _Ev(mk, 160, 161, True),
        _Ev("c", 170, 200, True),
        _Ev(mk, 210, 211, True),
        _Ev("d", 600, 700, True),
    ]
    s = trace.summarize(ev, "cuda", ["ingest", "route", "/route", "/ingest"])
    assert s.range_count["route"] == 1 and s.range_count["ingest"] == 1
    assert s.range_ops == dict(s.range_ops, route=2, ingest=3)
    assert s.range_device_s["route"] == pytest.approx(30e-9)
    assert s.range_device_s["ingest"] == pytest.approx(60e-9)
    assert s.window_s == pytest.approx(1000e-9)
    # busy: the markers, a, b, c and d
    assert s.busy_s == pytest.approx((4 + 20 + 10 + 30 + 100) * 1e-9)
    assert dict(s.device_ops)["d"] == pytest.approx(100e-9)
    # each idle gap goes to what the host was doing where it began
    causes = dict(s.idle_gaps)
    assert causes["route:aten::sort"] == pytest.approx(10e-9)  # b ends at 150, inside the sort
    assert causes["ingest:python"] == pytest.approx(389e-9)  # 211 to 600
    assert causes["loop:python"] == pytest.approx(400e-9)  # 0 to 100 and 700 to 1000
    # a mismatch between markers and ranges leaves the ranges unread
    s = trace.summarize(ev, "cuda", ["ingest", "/ingest"])
    assert not s.range_ops and "error" in s.diagnostics


def test_the_benchmark_loads_neither_jax_nor_the_jax_package():
    code = f"""
import sys
sys.path[:0] = [{str(ROOT)!r}, {str(ROOT / 'src')!r}]
def tops():
    return {{m.split('.', 1)[0] for m in sys.modules}}
from d4m_bench import reference, stream, roofline, trace
assert not tops() & {{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}}, tops()
from d4m_bench import harness
import json
spec = json.load(open({str(ROOT / 'BENCHMARK.json')!r}))
for m in spec['end_to_end'] + spec['per_layer']:
    harness.reader(m['name'])
import pathlib
for kind in ('ops', 'loops'):
    for f in sorted(pathlib.Path({str(ROOT / 'd4m_bench')!r}, kind).glob('*.py')):
        harness.find(kind, f.stem)
assert not tops() & {{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}}, tops()
import repro_torch.d4m, repro_torch.kernels._build, repro_torch.core.assoc
bad = tops() & {{'jax', 'jaxlib', 'flax', 'repro'}}
assert not bad, bad
print('ok')
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(__import__("os").environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "d4m_bench" / "run.py"), "--workload", SPEC["workloads"][0]["name"],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert out.stdout == ""
