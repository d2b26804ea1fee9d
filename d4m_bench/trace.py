"""Reading the profiler's trace of a window: device busy time, idle gaps,
and the device time of the operations each of the benchmark's own ranges
launched.

On the card every range (``Marks``) is a ``record_function`` range on the
host and also puts a marker kernel (``torch.cuda._sleep(1)``, a spin
kernel the program never launches) on the stream where it opens and where
it closes.  The program runs on one stream, in order, so every device
operation between a range's two markers on the device's timeline is one
that range launched, whatever it is named and however it was launched (the
port's kernels launch through the CUDA runtime linked into their own
libraries, which the profiler does not link to a host call).
"""
from __future__ import annotations

import collections
import contextlib
from typing import Dict, List, Optional, Tuple

import numpy as np

WINDOW = "window"
MARKER = "spin_kernel"


class Marks:
    """Ranges for a traced window on the card: ``with marks("view"): ...``.
    ``labels`` lists, in launch order, what each marker kernel stands for:
    ``name`` where a range opens, ``/name`` where it closes."""

    def __init__(self, torch):
        from torch.profiler import record_function

        self._rf = record_function
        self._sleep = torch.cuda._sleep
        self.labels: List[str] = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        with self._rf(name):
            self.labels.append(name)
            self._sleep(1)
            try:
                yield
            finally:
                self.labels.append("/" + name)
                self._sleep(1)


class TraceSummary:
    """What the readers of per-layer metrics take from one traced window."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.range_count: Dict[str, int] = {}
        self.range_device_s: Dict[str, float] = {}
        self.range_ops: Dict[str, int] = {}
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.diagnostics: Dict[str, object] = {}

    def breakdown(self) -> dict:
        return {"device_ops": [list(x) for x in self.device_ops],
                "idle_gaps": [list(x) for x in self.idle_gaps]}


def _merge(intervals: np.ndarray) -> np.ndarray:
    """Union of ``[n, 2]`` intervals as sorted, disjoint ``[m, 2]``."""
    if len(intervals) == 0:
        return intervals.reshape(0, 2)
    iv = intervals[np.argsort(intervals[:, 0], kind="stable")]
    out = []
    s, e = iv[0]
    for a, b in iv[1:]:
        if a > e:
            out.append((s, e))
            s, e = a, b
        elif b > e:
            e = b
    out.append((s, e))
    return np.asarray(out, dtype=np.int64)


def _containing(starts: np.ndarray, ends: np.ndarray, t: np.ndarray, depth: int = 8) -> np.ndarray:
    """For each time in ``t``, the index of the latest-starting interval
    (of ``starts``/``ends``, sorted by start, nested) that contains it, or
    -1.  Looks back ``depth`` intervals, the nesting depth it resolves."""
    out = np.full(t.shape, -1, dtype=np.int64)
    if len(starts) == 0:
        return out
    idx = np.searchsorted(starts, t, side="right") - 1
    for back in range(depth):
        j = idx - back
        ok = (out < 0) & (j >= 0)
        jj = np.where(ok, j, 0)
        hit = ok & (ends[jj] >= t)
        out[hit] = jj[hit]
    return out


def _by_range(s: TraceSummary, ops, marks, labels: List[str]) -> None:
    """Attribute each device op to every range open around it on the
    device's timeline (between its markers)."""
    for name in labels:
        if not name.startswith("/"):
            s.range_count[name] = s.range_count.get(name, 0) + 1
            s.range_device_s[name] = 0.0
            s.range_ops[name] = 0
    open_ = collections.Counter()
    m = 0
    for a, b, _ in ops:
        while m < len(marks) and marks[m] <= a:
            lab = labels[m]
            if lab.startswith("/"):
                open_[lab[1:]] -= 1
            else:
                open_[lab] += 1
            m += 1
        for name, n in open_.items():
            if n > 0:
                s.range_ops[name] += 1
                s.range_device_s[name] += (b - a) / 1e9


def summarize(events, device_type_cuda, labels: Optional[List[str]] = None,
              top: int = 10) -> TraceSummary:
    """Reduce raw kineto events (``prof.profiler.kineto_results.events()``)
    of one window to a :class:`TraceSummary`; ``labels`` are the window's
    :class:`Marks` labels.  Every user range on the host is one of the
    benchmark's."""
    names = {x.lstrip("/") for x in labels or ()} | {WINDOW}
    ranges = collections.defaultdict(list)  # name -> [(start, end, thread)]
    host_ops = []  # (start, end, name, thread)
    ops, marks, mark_ops = [], [], []
    for e in events:
        name = e.name()
        t0, t1 = int(e.start_ns()), int(e.end_ns())
        if e.device_type() == device_type_cuda:
            if MARKER in name:
                marks.append(t0)
                mark_ops.append((t0, t1, name))
            elif not (e.is_user_annotation() or name in names):
                ops.append((t0, t1, name))
        elif e.is_user_annotation():
            ranges[name].append((t0, t1, int(e.start_thread_id())))
        else:
            host_ops.append((t0, t1, name, int(e.start_thread_id())))
    s = TraceSummary()
    s.diagnostics = {"device_ops": len(ops), "markers": len(marks),
                     "labels": None if labels is None else len(labels)}
    if not ranges.get(WINDOW):
        s.diagnostics["error"] = "no window range in the trace"
        return s
    w0, w1, main_tid = ranges[WINDOW][0]
    s.window_s = (w1 - w0) / 1e9
    ops.sort()
    marks.sort()
    if labels is not None and len(marks) == len(labels):
        _by_range(s, ops, marks, labels)
    elif labels is not None:
        s.diagnostics["error"] = "markers on the device do not match the ranges opened"

    # busy time and idle gaps inside the window (the markers ran too: while
    # one runs the device is not idle)
    iv = np.asarray([(max(a, w0), min(b, w1)) for a, b, _ in ops + mark_ops if b > w0 and a < w1],
                    dtype=np.int64).reshape(-1, 2)
    busy = _merge(iv)
    s.busy_s = float((busy[:, 1] - busy[:, 0]).sum()) / 1e9 if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.reshape(-1), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]

    # what the host was doing when each gap began: the innermost range
    # inside the window ("loop" where none is open) and the innermost host
    # operation (or plain Python) on the window's thread
    at = gaps[:, 0]
    host = sorted((a, b, n) for a, b, n, tid in host_ops if tid == main_tid)
    op = _containing(np.asarray([h[0] for h in host], dtype=np.int64),
                     np.asarray([h[1] for h in host], dtype=np.int64), at)
    spans = sorted((a, b, n) for n, rs in ranges.items() if n != WINDOW for a, b, tid in rs if tid == main_tid)
    inner = _containing(np.asarray([x[0] for x in spans], dtype=np.int64),
                        np.asarray([x[1] for x in spans], dtype=np.int64), at)
    by_cause = collections.Counter()
    for g, r, o in zip(gaps, inner, op):
        where = spans[r][2] if r >= 0 else "loop"
        by_cause[f"{where}:{host[o][2] if o >= 0 else 'python'}"] += float(g[1] - g[0]) / 1e9
    s.idle_gaps = [(k[:64], v) for k, v in by_cause.most_common(top)]

    by_op = collections.Counter()
    for a, b, name in ops:
        if b > w0 and a < w1:
            by_op[name[:64]] += (min(b, w1) - max(a, w0)) / 1e9
    s.device_ops = by_op.most_common(top)
    return s
