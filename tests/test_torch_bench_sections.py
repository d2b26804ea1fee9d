"""The port's nine bench sections, run on the CPU at tiny sizes.

Each section's ``main`` runs once with ``device="cpu"`` into its own directory;
its ``BENCH_<section>.json`` must load in the reference's parsers with the
same normalized record as the port's, and the reference's gate must give
the port's result, on an empty history and against the run itself.  The
correctness fields hold: ``hier``'s snapshot per cut schedule holds numpy's
distinct keys of the stream with each key's count as its value, streams
are conserved, ``bit_identical`` and ``scrape_exact`` are true.  The knobs
the chip's full-width spec turns run here at tiny sizes too.  The scaling section's D axis raises until the
mesh is ported.  (Nothing here runs a JAX function: the reference's bench
library is plain Python.)
"""
import dataclasses
import os

import numpy as np
import pytest

import repro.bench as ref_bench
import repro_torch.bench as port_bench
from repro_torch.benchmarks import (
    bench_cascade_kernel,
    bench_embed_grad,
    bench_fleet,
    bench_hier_update,
    bench_kernels,
    bench_obs,
    bench_query,
    bench_scaling,
    bench_serve,
)
from repro_torch.data import rmat

from _torch_fleet import ENV as FLEET_CPU_ENV

HIER = dict(total_edges=40_000, group_size=1_000, scale=12)
SERVED = dict(batches=12, batch=128, scale=10)

# section -> (module, tiny kwargs, the artifact's section name)
SECTIONS = {
    "hier": (bench_hier_update, HIER, "hier_update"),
    "kernels": (bench_kernels, dict(smoke=True), "kernels"),
    "cascade_kernel": (bench_cascade_kernel, dict(smoke=True, k_values=(1, 4), steps=4),
                       "cascade_kernel"),
    "scaling": (bench_scaling, dict(k_values=(1, 4), groups=3, device_sweep=False), "scaling"),
    "embed": (bench_embed_grad, dict(smoke=True), "embed_grad"),
    "serve": (bench_serve, dict(SERVED, k_values=(1, 4)), "serve"),
    "query": (bench_query, dict(SERVED, k=4, publish_every=4), "query"),
    "obs": (bench_obs, dict(SERVED, k=4, publish_every=4, repeats=1), "obs"),
    "fleet": (bench_fleet, dict(hosts_values=(1, 2), k=2, total_records=3000, chunk=500,
                                batch=128, scale=10), "fleet"),
}


def _plain(x):
    return dataclasses.asdict(x)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Each section runs once a module: ``run(section)`` returns its
    measurements keyed by name (and engine and K where the params name
    them) and the normalized record, after holding both packages' parsers
    and gates to each other on its artifact."""
    done = {}

    def get(section):
        if section not in done:
            done[section] = _run(section, tmp_path_factory.mktemp(section))
        return done[section]

    return get


def _run(section, out_dir):
    mod, kwargs, name = SECTIONS[section]
    saved = os.environ.get("BENCH_JSON_DIR")
    os.environ["BENCH_JSON_DIR"] = str(out_dir)
    try:
        mod.main(device="cpu", **kwargs)
    finally:
        if saved is None:
            del os.environ["BENCH_JSON_DIR"]
        else:
            os.environ["BENCH_JSON_DIR"] = saved
    path = out_dir / f"BENCH_{name}.json"
    assert path.exists()
    ref_run = ref_bench.parse_section_file(str(path))
    port_run = port_bench.parse_section_file(str(path))
    assert ref_run.section == port_run.section == name
    assert ref_run.backend == "cpu" and ref_run.jax_version is None
    ref_rec, _ = ref_bench.normalize_dir(str(out_dir))
    port_rec, _ = port_bench.normalize_dir(str(out_dir))
    assert ref_rec.to_jsonl() == port_rec.to_jsonl()
    for history in ([], "self"):
        ref_gate = ref_bench.gate_run(ref_rec, [ref_rec] if history else [])
        port_gate = port_bench.gate_run(port_rec, [port_rec] if history else [])
        assert _plain(ref_gate) == _plain(port_gate)
        assert port_gate.passed
    return {m.name if not m.params.get("engine") else (m.name, m.params.get("engine"),
                                                        m.params.get("k")): m
            for m in port_rec.measurements}, port_rec


@pytest.mark.parametrize("section", sorted(SECTIONS))
def test_section_runs_on_the_cpu_and_reads_in_both_packages(section, run):
    by_name, rec = run(section)
    ms = rec.measurements
    # every leg records its kernels' launches (none on the CPU: the wrappers
    # take their plain versions there)
    legs = [m for m in ms if "launches" in m.extras]
    assert legs
    for m in legs:
        assert set(m.extras["launches"]) == {"hier_cascade", "merge_add", "scatter_add",
                                             "sort_dedup"}
        assert not any(m.extras["launches"].values())
    for field in ("nnz_exact", "values_exact", "conserved", "bit_identical", "scrape_exact",
                  "engines_agree", "allclose"):
        assert all(m.extras[field] is True for m in ms if field in m.extras), field
    assert not any(m.extras.get("overflow") for m in ms)


def test_hier_snapshot_holds_numpy_distinct_count(run):
    by_name, _ = run("hier")
    groups = list(rmat.edge_stream(np.random.default_rng(0), HIER["total_edges"],
                                   HIER["group_size"], HIER["scale"]))
    keys = np.unique(np.concatenate([g[0].astype(np.int64) * 2**32 + g[1] for g in groups]))
    for name in ("0cut", "2cut_wide", "4cut_close", "8cut_close"):
        m = by_name[(name, "single", None)]
        assert m.extras["snapshot_nnz"] == keys.size, name
        assert m.extras["distinct_keys"] == keys.size
    # the paper's shape: more cuts ingest faster than none
    assert by_name["verdict_hier_beats_flat"].passed is not None


def test_conservation_and_bit_flags(run):
    by_name, _ = run("serve")
    served = [m for k, m in by_name.items() if isinstance(k, tuple) and k[0] == "served_rate"]
    assert served and all(m.extras["conserved"] for m in served)
    assert all(m.extras["records_fed"] == SERVED["batches"] * SERVED["batch"] for m in served)
    verdict = by_name["feed_efficiency"]
    assert verdict.params["floor"] == bench_serve.EFFICIENCY_FLOOR == 0.5
    by_name, _ = run("query")
    q = by_name[("query_cost", "packed", None)]
    assert q.extras["bit_identical"] is True
    assert q.passed == (q.extras["within_ceiling"] and q.extras["bit_identical"])
    assert q.params["ceiling"] == bench_query.COST_CEILING == 0.10
    by_name, _ = run("obs")
    o = by_name["obs_overhead"]
    assert o.extras["bit_identical"] is True and o.extras["scrape_exact"] is True
    assert o.params["ceiling"] == bench_obs.OVERHEAD_CEILING == 0.02


def test_fleet_conserves_and_keeps_its_floor(run):
    assert bench_fleet.WORKER_ENV == FLEET_CPU_ENV
    by_name, rec = run("fleet")
    rates = [m for m in rec.measurements if m.name == "fleet_rate"]
    assert [m.params["hosts"] for m in rates] == [1, 2]
    assert all(m.extras["conserved"] and m.extras["records_delivered"] == 3000 for m in rates)
    assert by_name["fleet_scaling"].params["floor"] == bench_fleet.EFFICIENCY_FLOOR == 0.7


def test_lane_skip_verdict_keeps_its_rule(run):
    _, rec = run("cascade_kernel")
    for m in rec.measurements:
        if m.name == "lane_skip_speedup":
            assert m.passed == (m.extras["speedup"] >= 2.0 and m.extras["cascades_per_step"] == 0.0)
    engines = {m.params["engine"] for m in rec.measurements if m.name == "cascade_step"}
    assert engines == {"cuda", "packed", "single"}


CUTS = (128, 1024, 4096)
# section -> (module, the knobs the chip's full-width spec turns, at tiny sizes)
WIDE = {
    "kernels": (bench_kernels, dict(merge_sizes=[256], sort_shapes=[[4, 256]],
                                    scatter_shapes=[[300, 8, 40]])),
    "cascade_kernel": (bench_cascade_kernel, dict(k_values=(2,), batch=512, steps=3)),
    "embed": (bench_embed_grad, dict(shapes=[[500, 8, 64, 3]])),
    "serve": (bench_serve, dict(SERVED, k_values=(1, 4), cuts=CUTS, top_capacity=[3000, 2000],
                                track_degrees=False, socket_records=300)),
    "query": (bench_query, dict(SERVED, k=4, publish_every=4, cuts=CUTS, top_capacity=2000,
                                track_degrees=False)),
    "obs": (bench_obs, dict(SERVED, k=4, publish_every=4, repeats=1, cuts=CUTS,
                            top_capacity=2000, track_degrees=False)),
    "fleet": (bench_fleet, dict(hosts_values=(1,), k=2, total_records=3000, chunk=500,
                                batch=128, scale=10, cuts=CUTS, top_capacity=2000,
                                track_degrees=False)),
}


@pytest.mark.parametrize("section", sorted(WIDE))
def test_full_width_knobs_at_tiny_size(section, tmp_path, monkeypatch):
    """The knobs ``chip.json`` turns (shapes, cuts, top capacity, untracked
    serve, a socket prefix) run here at tiny sizes, land in the params, and
    keep every correctness field true."""
    mod, kwargs = WIDE[section]
    monkeypatch.setenv("BENCH_JSON_DIR", str(tmp_path))
    mod.main(device="cpu", **kwargs)
    rec, problems = port_bench.normalize_dir(str(tmp_path), strict=True)
    assert not problems
    ref_rec, _ = ref_bench.normalize_dir(str(tmp_path))
    assert ref_rec.to_jsonl() == rec.to_jsonl()
    ms = rec.measurements
    for field in ("nnz_exact", "values_exact", "conserved", "bit_identical", "scrape_exact",
                  "engines_agree", "allclose"):
        assert all(m.extras[field] is True for m in ms if field in m.extras), field
    if "cuts" in kwargs:
        legs = [m for m in ms if "launches" in m.extras]
        assert all(m.params["cuts"] == list(CUTS) and m.params["track_degrees"] is False
                   for m in legs)
        tops = {m.params["k_per_device"]: m.params["top_capacity"] for m in legs}
        assert tops == ({1: 3000, 4: 2000} if section == "serve"
                        else {kwargs.get("k"): 2000})
    if section == "serve":
        sock = [m for m in ms if m.name == "socket_rate"]
        assert [m.params["socket_records"] for m in sock] == [300, 300]
        assert all(m.extras["conserved"] for m in sock)
        assert all("values_exact" in m.extras for m in ms if "launches" in m.extras)
    if section == "kernels":
        assert {m.name for m in ms} == {"merge_add", "sort_dedup", "scatter_add"}
        assert all(m.extras["bit_identical"] is True for m in ms)
        assert [m.params for m in ms if m.name == "sort_dedup"] == [{"n": 256, "k": 4}]
    if section == "cascade_kernel":
        assert all(m.params["batch"] == 512 for m in ms)


def test_schedules_scale_with_the_batch():
    assert all(bench_cascade_kernel.schedule(n) == bench_cascade_kernel.SCHEDULES[n]
               for n in bench_cascade_kernel.SCHEDULES)
    assert bench_cascade_kernel.schedule("0pct", 512) == ((1024, 8192), 32768, 400)
    assert bench_cascade_kernel.schedule("hot", 512) == ((1024, 8192), 32768, 1 << 30)


def test_holds_counts_checks_every_key_and_value():
    import torch

    from repro_torch.benchmarks import _common
    from repro_torch.core import assoc

    rng = np.random.default_rng(3)
    rows, cols = rng.integers(0, 20, 500).astype(np.int32), rng.integers(0, 20, 500).astype(np.int32)
    want = _common.key_counts(rows, cols)
    assert want[1].sum() == 500 and _common.distinct_keys(rows, cols) == want[0].size
    snap = assoc.from_triples(torch.from_numpy(rows), torch.from_numpy(cols),
                              torch.ones(500), cap=512)
    assert _common.holds_counts(snap, want)
    off = dataclasses.replace(snap, vals=snap.vals.clone())
    off.vals[3] += 1
    assert not _common.holds_counts(off, want)
    short = assoc.from_triples(torch.from_numpy(rows[:-1]), torch.from_numpy(cols[:-1]),
                               torch.ones(499), cap=512)
    assert not _common.holds_counts(short, want)


def test_scaling_d_axis_waits_for_the_mesh():
    with pytest.raises(NotImplementedError, match="A6"):
        bench_scaling.main(k_values=(1,), groups=2, device_sweep=True, device="cpu")
    with pytest.raises(NotImplementedError, match="A6"):
        bench_scaling.update_path_collectives()


def test_sections_want_cuda_unless_told(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for mod, kwargs, _ in SECTIONS.values():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            mod.main(**{k: v for k, v in kwargs.items() if k != "device_sweep"},
                     **({"device_sweep": False} if mod is bench_scaling else {}))
