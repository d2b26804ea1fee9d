"""Straggler mitigation for synchronous data-parallel training (port of
``repro.runtime.straggler``, which imports no JAX: a copy).

At 1000+ nodes the slowest worker sets the step time (tail latency).  The
mitigation here is host-side (the device program is unchanged):
**deadline + backup dispatch** (``StragglerMonitor``): per-step wall-time
EWMA; a step exceeding ``deadline_factor`` x EWMA is flagged, and flagged
workers are reported to the elastic controller for replacement after
``evict_after`` consecutive violations — the standard "detect, don't
block" policy.

Stragglers are injected in the tests (``tests/test_torch_runtime.py``) to
exercise the full detect->flag->evict path deterministically.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional


@dataclasses.dataclass
class StragglerConfig:
    deadline_factor: float = 2.0  # x EWMA -> violation
    ewma: float = 0.9
    evict_after: int = 3  # consecutive violations before eviction


class StragglerMonitor:
    def __init__(self, n_workers: int, cfg: StragglerConfig = StragglerConfig()):
        self.cfg = cfg
        self.n = n_workers
        self.ewma_ms: Optional[float] = None
        self.violations: Dict[int, int] = {w: 0 for w in range(n_workers)}
        self.flagged: List[int] = []

    def observe_step(self, worker_times_ms: Dict[int, float]) -> List[int]:
        """Feed per-worker step times; returns workers to evict this step."""
        fastest = min(worker_times_ms.values())
        if self.ewma_ms is None:
            self.ewma_ms = fastest
        else:
            self.ewma_ms = self.cfg.ewma * self.ewma_ms + (1 - self.cfg.ewma) * fastest
        deadline = self.cfg.deadline_factor * self.ewma_ms
        evict = []
        for w, t in worker_times_ms.items():
            if t > deadline:
                self.violations[w] += 1
                if self.violations[w] >= self.cfg.evict_after:
                    evict.append(w)
                    self.violations[w] = 0
            else:
                self.violations[w] = 0
        self.flagged = [w for w, v in self.violations.items() if v > 0]
        return evict


class StepTimer:
    """Context-manager step timer feeding the monitor (per-host)."""

    def __init__(self):
        self.last_ms: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.last_ms = (time.perf_counter() - self._t0) * 1e3
        return False
