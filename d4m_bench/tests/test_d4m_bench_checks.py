"""The comparison that decides ``correct`` has to fail where the program is
wrong: the control (the program's own bfloat16 path, the nearest precision
below the configuration's float32) and the faults a cell can have, planted
under a run that the harness otherwise drives as it drives the card's.

On the CPU at the size ``harness.shrink`` gives; marked ``cuda``, at each
cell's own size on three seeds, printing the readings (``-s``)."""
import json

import pytest
import torch

from conftest import ROOT
from d4m_bench import harness

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]
QUERY_CELLS = [w for w in CELLS if harness.load_cell(w).traffic.get("query_every_groups")]


def _unchanged(sess):
    """A step that returns its state unchanged."""
    sess._step = lambda h, rows, cols, vals: h


def _half(sess):
    """Half of every ingested batch left out."""
    from repro_torch.core.assoc import PAD

    route = sess.route

    def routed(rows, cols, vals):
        rows = rows.clone()
        rows[rows.shape[-1] // 2:] = PAD
        return route(rows, cols, vals)

    sess.route = routed


def _altered_answers(monkeypatch):
    """Every query answer altered where it is produced (one count)."""
    from repro_torch.d4m.session import StreamView

    top_k = StreamView.top_k

    def altered(self, k=10, by="out"):
        ids, counts = top_k(self, k, by)
        counts = counts.clone()
        counts[-1] += 1
        return ids, counts

    monkeypatch.setattr(StreamView, "top_k", altered)


def _planted(monkeypatch, fault):
    """Every session the harness builds gets ``fault``."""
    build = harness.build_session

    def faulty(cell, device):
        sess = build(cell, device)
        fault(sess)
        return sess

    monkeypatch.setattr(harness, "build_session", faulty)


def _run(workload, variant, seed, seconds, device, monkeypatch):
    cell = harness.load_cell(workload)
    if device == "cpu":
        cell = harness.shrink(cell)
    if variant == "control":  # the program's own bfloat16 path
        cell.config = dict(cell.config, session=dict(cell.config["session"], dtype="bfloat16"))
    elif variant == "unchanged":
        _planted(monkeypatch, _unchanged)
    elif variant == "half":
        _planted(monkeypatch, _half)
    elif variant == "altered":
        _altered_answers(monkeypatch)
    result = harness.run_cell(cell, seed, seconds, False, device=device)
    readings = {k: v["value"] for k, v in result["compared"].items()}
    print(json.dumps({"cell": workload, "variant": variant, "seed": seed, "correct": result["correct"],
                      "counts": result["counts"], "readings": readings}), flush=True)
    return result, readings


#: the numbers of which each planted fault or the control must move one
EXPECT = {
    "control": ("state_value_err", "view_value_err", "queries_wrong"),
    "unchanged": ("state_keys_wrong", "view_keys_wrong", "queries_wrong"),
    "half": ("state_keys_wrong", "state_value_err", "view_keys_wrong", "view_value_err", "queries_wrong"),
    "altered": ("queries_wrong",),
}

CASES = [(w, v) for w in CELLS for v in ("sound", "control", "unchanged", "half")]
CASES += [(w, "altered") for w in QUERY_CELLS]


@pytest.mark.parametrize("workload,variant", CASES)
def test_comparison_on_the_cpu(workload, variant, monkeypatch):
    torch.set_num_threads(1)
    result, readings = _run(workload, variant, 11, 1.5, "cpu", monkeypatch)
    assert result["counts"]["groups"] > 0
    if workload in QUERY_CELLS:
        assert result["counts"]["queries"] > 0
    assert result["correct"] == (variant == "sound")
    if variant != "sound":
        assert any(readings.get(name, 0) > 0 for name in EXPECT[variant])


FULL_SIZE = [(w, v) for w, v in CASES if v != "sound"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload,variant", FULL_SIZE)
def test_comparison_at_the_cells_size(workload, variant, monkeypatch, cuda_device):
    """Three seeds at the cell's own size and load, a short window each."""
    import os

    os.environ.setdefault("REPRO_TORCH_BUILD_DIR", str(ROOT / "d4m_bench" / ".build"))
    for seed in (9001, 9002, 9003):
        result, readings = _run(workload, variant, seed, 5.0, cuda_device, monkeypatch)
        assert not result["correct"]
        assert any(readings.get(name, 0) > 0 for name in EXPECT[variant])
