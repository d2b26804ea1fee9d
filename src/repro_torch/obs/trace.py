"""Bounded trace ring + opt-in PyTorch profiler hook (port of
``repro.obs.trace``).

:class:`TraceRing` keeps the last N structured span events (stage name,
start/end ``perf_counter_ns``, batch size, worker id, ...) in a fixed-size
ring: appending is O(1), memory is bounded no matter how long the server
runs, and the whole ring dumps to JSONL for offline timeline tools.  The
ring takes a short lock per append — it is *not* on the per-record hot
path, only at microbatch boundaries (one span per dispatched batch), so
the cost is amortized over the batch.

:func:`torch_profile` runs ``torch.profiler.profile`` (CPU, and CUDA where
the card is present) as a context manager that writes a Chrome trace into
a configured directory, and degrades to a no-op when no directory is
configured or the profiler is unavailable; the serve loop can always wrap
itself in it.
"""
from __future__ import annotations

import contextlib
import json
import threading
import time
from typing import Any, Dict, Iterator, List, Optional

DEFAULT_CAPACITY = 4096


class TraceRing:
    """Fixed-capacity ring of span-event dicts (oldest evicted first)."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        cap = int(capacity)
        if cap <= 0:
            raise ValueError(f"capacity must be positive, got {capacity}")
        self.capacity = cap
        self._lock = threading.Lock()
        self._buf: List[Optional[Dict[str, Any]]] = [None] * cap
        self._next = 0
        self.total = 0  # appends ever, including evicted

    def append(
        self,
        stage: str,
        t0_ns: int,
        t1_ns: int,
        **fields: Any,
    ) -> None:
        ev = {"stage": str(stage), "t0_ns": int(t0_ns), "t1_ns": int(t1_ns)}
        ev.update(fields)
        with self._lock:
            self._buf[self._next] = ev
            self._next = (self._next + 1) % self.capacity
            self.total += 1

    @contextlib.contextmanager
    def span(self, stage: str, **fields: Any) -> Iterator[None]:
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self.append(stage, t0, time.perf_counter_ns(), **fields)

    def events(self) -> List[Dict[str, Any]]:
        """Retained events, oldest first."""
        with self._lock:
            if self.total < self.capacity:
                kept = self._buf[: self._next]
            else:
                kept = self._buf[self._next:] + self._buf[: self._next]
            return [dict(e) for e in kept if e is not None]

    def dump_jsonl(self, path: str) -> int:
        """Write retained events as JSON lines; returns the line count."""
        events = self.events()
        with open(path, "w", encoding="utf-8") as fh:
            for ev in events:
                fh.write(json.dumps(ev, sort_keys=True) + "\n")
        return len(events)


@contextlib.contextmanager
def torch_profile(log_dir: Optional[str]) -> Iterator[None]:
    """``torch.profiler.profile`` over the block when a directory is
    configured and the profiler starts cleanly, its Chrome trace written to
    ``<log_dir>/trace-<pid>-<ns>.json`` on exit; a plain no-op otherwise."""
    if not log_dir:
        yield
        return
    try:
        import os

        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        os.makedirs(str(log_dir), exist_ok=True)
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:
        yield
        return
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        path = os.path.join(str(log_dir), f"trace-{os.getpid()}-{time.perf_counter_ns()}.json")
        try:
            prof.export_chrome_trace(path)
        except Exception:
            pass
