"""One run of one cell: set-up, the measured window, the comparison with the
plain reference, and the result line.

Everything particular to a cell lives in files found by name:
``BENCHMARK.json`` names the cell's configuration (``configs/<config>.json``:
the session it runs), its traffic mix (``traffic/<mix>.json``: the stream's
parameters, read by the one generator ``stream.py``; the loop that paces it,
``loops/<loop>.py``; its queries, each ``ops/<op>.py``: how one is issued on
a view and how its answers are checked against the reference) and its
metrics (``metrics/<metric>.py``: one reader each over the :class:`Record`
of the run).

The window repeats one epoch of the stream: the loop hands groups to
``D4MStream.ingest`` and issues the mix's queries (in turn, each over a
fresh ``view()``, timed on the host to its answer on the host), and
between epochs ``reset()`` empties the session.  With ``--trace 1`` the
window runs under ``torch.profiler`` for ``trace_seconds`` at most, with
the benchmark's own ranges around its calls into the program.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent

#: top-level modules that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


@dataclasses.dataclass
class Cell:
    name: str
    workload: dict
    config: dict  # the configuration's file
    traffic: dict  # the traffic mix's file
    metrics: List[dict]  # this cell's metric entries of BENCHMARK.json, both kinds


@dataclasses.dataclass
class Record:
    """What one window did, for the metric readers."""

    t0: float = 0.0  # perf_counter at the first timed group
    setup_s: float = 0.0
    window_s: float = 0.0
    groups: int = 0
    updates: int = 0  # accepted: offered less dropped
    dropped: int = 0
    queries: int = 0
    epochs: int = 0
    latencies_s: List[float] = dataclasses.field(default_factory=list)
    cascades: List[int] = dataclasses.field(default_factory=list)  # per layer, over the window
    cuts: List[int] = dataclasses.field(default_factory=list)
    value_itemsize: int = 4
    state_entries: List[int] = dataclasses.field(default_factory=list)  # per view: live entries read
    view_entries: List[int] = dataclasses.field(default_factory=list)  # per view: entries written
    peak_bytes_per_s: Optional[float] = None
    trace: object = None  # trace.TraceSummary of a traced window


@functools.lru_cache(maxsize=None)
def find(kind: str, name: str) -> ModuleType:
    """The module ``<kind>/<name>.py`` of the benchmark: a metric's reader,
    a loop, a query op."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"no {kind[:-1]} {name!r}: {path} does not exist")
    spec = importlib.util.spec_from_file_location(f"d4m_bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """``read`` of ``metrics/<metric>.py``."""
    return find("metrics", metric).read


def load_cell(workload: str) -> Cell:
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    by_name = {w["name"]: w for w in spec["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(by_name)}")
    w = by_name[workload]
    cfg = next(c for c in spec["configs"] if c["name"] == w["config"])
    metrics = [dict(m, kind=kind) for kind in ("end_to_end", "per_layer") for m in spec[kind]
               if "workloads" not in m or workload in m["workloads"]]
    cell = Cell(name=workload, workload=w, config=json.loads((ROOT / cfg["file"]).read_text()),
                traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text()), metrics=metrics)
    check(cell)
    return cell


def check(cell: Cell) -> None:
    """Refuse a cell whose traffic names a generator, loop or op the
    benchmark does not have, or whose views cannot hold an epoch."""
    t = cell.traffic
    if t.get("generator") != "rmat":
        raise ValueError(f"traffic {t.get('name')!r}: the one generator is 'rmat'")
    if t.get("window_end", "deadline") not in ("deadline", "epoch"):
        raise ValueError(f"traffic {t.get('name')!r}: window_end is 'deadline' or 'epoch'")
    if bool(t.get("queries")) != bool(t.get("query_every_groups")):
        raise ValueError(f"traffic {t.get('name')!r}: queries and query_every_groups go together")
    find("loops", t["loop"])
    for q in t.get("queries") or []:
        find("ops", q["op"])
    epoch = int(t["group_size"]) * int(t["epoch_groups"])
    cap = cell.config["session"].get("snapshot_cap")
    if t.get("queries") and cap is not None and int(cap) < epoch:
        raise ValueError(f"cell {cell.name!r}: snapshot_cap {cap:,} cannot hold a view of an epoch of {epoch:,}")


def _ranged(rf, name: str, fn):
    def call(*args, **kwargs):
        with rf(name):
            return fn(*args, **kwargs)
    return call


def _state_counters(torch, state, n_layers: int):
    """Device-side sums of a state's cascade counters (per layer) and of its
    overflow flags, with no read to the host."""
    casc = state.cascades.reshape(-1, n_layers).sum(0, dtype=torch.int64)
    ovf = sum(l.overflow.reshape(-1).sum(dtype=torch.int64) for l in state.layers)
    return casc, ovf


def build_session(cell: Cell, device):
    from repro_torch.d4m import D4MStream, StreamConfig

    return D4MStream(StreamConfig.from_dict(cell.config["session"]), device=device)


class Window:
    """What a loop (``loops/<loop>.py``, ``run(window)``) drives: the
    session, the epoch of the stream and the mix's queries, and the counts
    the readers and the comparison take from the window."""

    def __init__(self, torch, sess, stream, traffic: dict, seconds: float, rf):
        self.torch, self.sess, self.stream, self.traffic, self.rf = torch, sess, stream, traffic, rf
        self.n_groups = int(stream[0].shape[0])
        self.queries = [(find("ops", q["op"]), q) for q in traffic.get("queries") or []]
        self.t0 = time.perf_counter()
        self.deadline = self.t0 + seconds
        self.g = self.groups = self.epochs = 0  # g: groups of the current epoch ingested
        self.n_layers = sess.plan.n_layers
        dev = sess.device
        self.casc_acc = torch.zeros(self.n_layers, dtype=torch.int64, device=dev)
        self.ovf_acc = torch.zeros((), dtype=torch.int64, device=dev)
        self.dropped = torch.zeros((), dtype=torch.int64, device=dev)
        self.latencies: List[float] = []
        self.answers = []  # (groups of the epoch ingested before it, query index, answer)
        self.view = None
        self.view_nnz, self.state_entries = [], []

    def ingest(self) -> int:
        """Hand the epoch's next group to ``ingest``; returns the groups of
        the epoch ingested so far."""
        src, dst, vals = self.stream
        with self.rf("ingest"):
            self.dropped += self.sess.ingest(src[self.g], dst[self.g], vals[self.g])
        self.g += 1
        self.groups += 1
        return self.g

    def query(self, t_issue: Optional[float] = None) -> None:
        """The mix's next query over a fresh view, timed from ``t_issue``
        (default: now) to its answer on the host."""
        i = len(self.latencies) % len(self.queries)
        op, q = self.queries[i]
        tq = time.perf_counter() if t_issue is None else t_issue
        with self.rf("query"):
            with self.rf("view"):
                self.view = self.sess.view()
            with self.rf(q["op"]):
                answer = op.issue(self.view, q)
        self.latencies.append(time.perf_counter() - tq)
        self.answers.append((self.g, i, answer))
        self.view_nnz.append(self.view.snap.nnz)
        self.state_entries.append(self.view.nnz)

    def next_epoch(self) -> None:
        """Empty the session; the stream starts over."""
        with self.rf("reset"):
            c, o = _state_counters(self.torch, self.sess.state, self.n_layers)
            self.casc_acc += c
            self.ovf_acc += o
            self.sess.reset()
        self.g = 0
        self.epochs += 1


def run_window(torch, sess, stream, traffic: dict, seconds: float, rf, profiler=None):
    """The measured window.  Returns ``(record, outputs)``: the counts for
    the readers, and what the program produced for the comparison."""
    dev = sess.device
    with contextlib.ExitStack() as stack:
        if profiler is not None:
            stack.enter_context(profiler)
        with rf("window"):
            w = Window(torch, sess, stream, traffic, seconds, rf)
            find("loops", traffic["loop"]).run(w)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            t1 = time.perf_counter()
    rec = Record(t0=w.t0, window_s=t1 - w.t0, groups=w.groups, queries=len(w.latencies), epochs=w.epochs,
                 latencies_s=w.latencies, state_entries=w.state_entries)
    rec.dropped = int(w.dropped)
    rec.updates = w.groups * int(stream[0].shape[1]) - rec.dropped
    rec.cuts = list(sess.cuts)
    rec.value_itemsize = sess.dtype.itemsize
    rec.view_entries = [int(x) for x in torch.stack(w.view_nnz).cpu()] if w.view_nnz else []
    tel = sess.telemetry()
    last = tel.cascades if tel.cascades is not None else tel.cascades_per_instance.sum(0)
    rec.cascades = [int(a) + int(b) for a, b in zip(w.casc_acc.cpu(), last)]
    out = {"offset": w.g, "answers": w.answers, "view": w.view,
           "view_offset": w.answers[-1][0] if w.answers else None,
           "overflows": int(w.ovf_acc) + int(_state_counters(torch, sess.state, w.n_layers)[1])}
    return rec, out


def _entries(torch, rows, cols, vals, nnz):
    """Live ``(keys, vals)`` of one packed array or a ``[K]`` stack of them:
    each array's first ``nnz`` slots."""
    from d4m_bench import reference

    cap = rows.shape[-1]
    rows, cols, vals = (x.reshape(-1, cap) for x in (rows, cols, vals))
    nnz = nnz.reshape(-1).to(torch.int64).cpu()
    keys, vs = [], []
    for i in range(rows.shape[0]):
        n = int(nnz[i])
        keys.append(reference.pack(rows[i, :n], cols[i, :n]))
        vs.append(vals[i, :n])
    return torch.cat(keys), torch.cat(vs)


def judge(torch, sess, stream, rec: Record, out: dict, traffic: dict) -> Dict[str, Dict[str, float]]:
    """Every number compared, each with its limit (all exact: limit 0).
    Takes the program's outputs, frees the session, then runs the
    reference."""
    from d4m_bench import reference

    src, dst, vals = stream
    parts = [_entries(torch, l.rows, l.cols, l.vals, l.nnz) for l in sess.state.layers]
    state = reference.fold(torch.cat([k for k, _ in parts]), torch.cat([v for _, v in parts]))
    del parts
    view = out.pop("view")
    if view is not None:
        s = view.snap
        view_sums = reference.fold(*_entries(torch, s.rows, s.cols, s.vals, s.nnz))
        view_overflow = int(s.overflow.reshape(-1).sum())
        del s
    del view
    sess.reset()
    del sess
    gc.collect()
    if src.device.type == "cuda":
        torch.cuda.empty_cache()

    # the reference, from the stream alone
    g = out["offset"]
    st = reference.compare_sums(*state, *reference.key_sums(src[:g], dst[:g], vals[:g]))
    res = {"dropped": rec.dropped, "overflows": out["overflows"],
           "state_keys_wrong": st["keys_wrong"], "state_value_err": st["value_err"]}
    if out["view_offset"] is not None:
        vo = out["view_offset"]
        vw = reference.compare_sums(*view_sums, *reference.key_sums(src[:vo], dst[:vo], vals[:vo]))
        res.update(view_keys_wrong=vw["keys_wrong"], view_value_err=vw["value_err"],
                   view_overflow=view_overflow)
    if out["answers"]:
        wrong = 0
        for i, q in enumerate(traffic["queries"]):
            mine = sorted(((g, a) for g, j, a in out["answers"] if j == i), key=lambda x: x[0])
            wrong += find("ops", q["op"]).count_wrong(stream, mine, q, traffic)
        res["queries_wrong"] = wrong
    return {name: {"value": float(v), "limit": 0.0} for name, v in res.items()}


def shrink(cell: Cell) -> Cell:
    """The same cell at a size the CPU runs in seconds: the CPU rehearsal's
    and the tests' (the widths of an entry and the loop are unchanged)."""
    t = dict(cell.traffic, scale=6, group_size=512, epoch_groups=24)
    if t.get("query_every_groups"):
        t["query_every_groups"] = 4
        t["queries"] = [dict(q, k=10) if "k" in q else q for q in t["queries"]]
    s = dict(cell.config["session"])
    kk = int(s.get("instances_per_device", 1))
    s.update(batch_size=512, cuts=[max(4, int(c) // 195 // kk) for c in s["cuts"]],
             top_capacity=12_288 // kk + 1_000, snapshot_cap=12_288)
    return dataclasses.replace(cell, traffic=t, config=dict(cell.config, session=s))


def forbidden_modules() -> List[str]:
    return sorted({m.split(".", 1)[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
             t_start: Optional[float] = None) -> dict:
    """Set up, measure, compare.  Returns the result object (without
    printing)."""
    import torch

    from d4m_bench import stream as stream_mod
    from d4m_bench import roofline

    t_start = time.perf_counter() if t_start is None else t_start
    on_card = device == "cuda"
    traffic = cell.traffic
    marks = [("start", t_start), ("imports", time.perf_counter())]
    if on_card:
        from repro_torch.kernels import _build

        _build.build_all(cell.config["kernels"])
        marks.append(("kernels", time.perf_counter()))
    stream = stream_mod.epoch(traffic, seed, device)
    marks.append(("stream", time.perf_counter()))
    sess = build_session(cell, device)
    sess.state
    marks.append(("session", time.perf_counter()))
    log(f"[setup] {cell.name}: engine {sess.kind}, {sess.n_instances} instance(s), caps {sess.plan.layer_caps}, "
        f"state {sess.plan.total_bytes:,} B planned, stream {sum(x.numel() * x.element_size() for x in stream):,} B "
        f"({stream[0].numel():,} updates an epoch)")

    # warm-up: one whole epoch through the window's own calls, with each
    # query of the mix at the first and the last query of an epoch, then
    # empty the session
    src, dst, vals = stream
    every = int(traffic.get("query_every_groups") or 0)
    last = (src.shape[0] // every) * every if every else 0
    for g in range(1, src.shape[0] + 1):
        sess.ingest(src[g - 1], dst[g - 1], vals[g - 1])
        if every and g in (every, last):
            for q in traffic["queries"]:
                find("ops", q["op"]).issue(sess.view(), q)
    sess.reset()
    if on_card:
        torch.cuda.synchronize()
    marks.append(("warm-up", time.perf_counter()))
    log("[setup] s: " + ", ".join(f"{name} {b - a:.3f}" for (_, a), (name, b) in zip(marks, marks[1:])))
    profiler = None
    rf = _null
    window = seconds
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from d4m_bench import trace as trace_mod

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
        profiler = profile(activities=acts)
        rf = trace_mod.Marks(torch) if on_card else record_function
        sess.route = _ranged(rf, "route", sess.route)
        sess.update = _ranged(rf, "update", sess.update)
        window = min(seconds, float(traffic["trace_seconds"]))
    rec, out = run_window(torch, sess, stream, traffic, window, rf, profiler)
    rec.setup_s = rec.t0 - t_start
    peak = torch.cuda.max_memory_allocated() if on_card else None
    if trace:
        rec.trace = trace_mod.summarize(profiler.profiler.kineto_results.events(),
                                        torch.autograd.DeviceType.CUDA, getattr(rf, "labels", None))
        log(f"[trace] {json.dumps(rec.trace.diagnostics)}")
        profiler = None
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    rec.peak_bytes_per_s = roofline.peak_bytes_per_s(name)
    compared = judge(torch, sess, stream, rec, out, traffic)
    del sess, out
    metrics = {}
    for m in cell.metrics:
        if (m["kind"] == "per_layer") != trace:
            continue
        v = reader(m["name"])(rec)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {
        "correct": all(c["value"] <= c["limit"] for c in compared.values()),
        "attempted": rec.groups * int(traffic["group_size"]) + rec.queries,
        "failed": rec.dropped,
        "metrics": metrics,
        "device": {"platform": "gpu" if on_card else "cpu", "kind": name,
                   "count": int(cell.workload["chips"]) if on_card else 0, "memory_peak_bytes": peak},
    }
    if trace and rec.trace is not None:
        result["device"].update(busy_s=rec.trace.busy_s, window_s=rec.trace.window_s)
        result["breakdown"] = rec.trace.breakdown()
    result["counts"] = {"groups": rec.groups, "queries": rec.queries, "epochs": rec.epochs,
                        "window_s": rec.window_s}
    result["compared"] = compared
    return result


def _null(name):
    return contextlib.nullcontext()


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
