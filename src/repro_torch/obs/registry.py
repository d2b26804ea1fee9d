"""Per-process metrics registry with a compiled-out disabled path.

Port of ``repro.obs.registry``, copied: it imports no JAX, and its wire
forms (environment variables, JSON, state dicts) are the reference's, so
what one package writes reads the same in the other.

The enable contract copies ``repro_torch.faults``: resolution happens once at
wiring time (config wins, else the :data:`OBS_ENV_VAR` environment
variable), and every instrumentation site holds either a pre-resolved
instrument handle or ``None``.  A disabled site is exactly one
``is not None`` check — no dict lookup, no allocation, no lock — so
observability-off behavior is bit-identical to a build without the plane
(the ``obs_overhead`` bench verdict pins this down).

Instruments:

* :class:`Counter` — monotonically increasing int, per-thread cells so
  ``inc()`` is lock-free and exact under concurrent writers;
* :class:`Gauge` — last-write-wins float (a single attribute store, which
  is atomic under the GIL);
* :class:`~repro_torch.obs.hist.LatencyHistogram` — see ``hist.py``.

``dump()`` emits a pure-JSON document a fleet worker can piggyback on its
control-channel telemetry messages; :meth:`MetricsRegistry.merge_dumps`
folds any number of dumps into one fleet view (counters and gauges sum,
histograms merge exactly — counts conserve).
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Iterable, List, Mapping, Optional

from repro_torch.obs import hist as _hist
from repro_torch.obs.hist import LatencyHistogram

#: Truthy values ("1", "true", "on", ...) enable the runtime metrics plane
#: process-wide wherever config leaves it unset.
OBS_ENV_VAR = "REPRO_OBS"

_TRUTHY = {"1", "true", "yes", "on"}
_FALSY = {"", "0", "false", "no", "off"}


def env_enabled(environ: Optional[Mapping[str, str]] = None) -> bool:
    env = os.environ if environ is None else environ
    return str(env.get(OBS_ENV_VAR, "")).strip().lower() in _TRUTHY


class Counter:
    """Monotonic event counter, exact under concurrent writers.

    Same sharding trick as the histogram: each thread increments a private
    cell (creation is the only locked moment in a writer's lifetime), and
    readers sum the cells.
    """

    def __init__(self, name: str = ""):
        self.name = str(name)
        self._local = threading.local()
        self._cells: List[List[int]] = []
        self._create_lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        cell = getattr(self._local, "cell", None)
        if cell is None:
            cell = [0]
            with self._create_lock:
                self._cells.append(cell)
            self._local.cell = cell
        cell[0] += int(n)

    @property
    def value(self) -> int:
        return sum(c[0] for c in list(self._cells))


class Gauge:
    """Last-write-wins scalar (one attribute store — atomic under the GIL)."""

    def __init__(self, name: str = ""):
        self.name = str(name)
        self.value: float = 0.0

    def set(self, value: float) -> None:
        self.value = float(value)


class MetricsRegistry:
    """Named counters/gauges/histograms for one process.

    ``counter``/``gauge``/``histogram`` are get-or-create and meant to be
    called once at wiring time; sites then hold the returned handle (or
    ``None`` when the registry itself is ``None``) and never come back
    here on the hot path.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, LatencyHistogram] = {}

    # -- wiring-time lookups --------------------------------------------------
    def counter(self, name: str) -> Counter:
        with self._lock:
            c = self._counters.get(name)
            if c is None:
                c = self._counters[name] = Counter(name)
            return c

    def gauge(self, name: str) -> Gauge:
        with self._lock:
            g = self._gauges.get(name)
            if g is None:
                g = self._gauges[name] = Gauge(name)
            return g

    def histogram(self, name: str) -> LatencyHistogram:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram(name)
            return h

    # -- read side ------------------------------------------------------------
    def dump(self) -> Dict[str, Any]:
        """Pure-JSON document: ``{counters, gauges, histograms}``."""
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            hists = dict(self._hists)
        return {
            "counters": {k: int(v.value) for k, v in sorted(counters.items())},
            "gauges": {k: float(v.value) for k, v in sorted(gauges.items())},
            "histograms": {k: h.state() for k, h in sorted(hists.items())},
        }

    def summaries(self) -> Dict[str, Dict[str, int]]:
        """``{hist_name: {count, p50_ns, p90_ns, p99_ns, max_ns}}`` for every
        non-empty histogram — all integers (JSON bit-exact)."""
        with self._lock:
            hists = dict(self._hists)
        out = {}
        for name, h in sorted(hists.items()):
            st = h.state()
            if _hist.state_count(st):
                out[name] = _hist.summarize_state(st)
        return out

    def to_prometheus(self) -> str:
        return dump_to_prometheus(self.dump())

    # -- cross-process algebra ------------------------------------------------
    @staticmethod
    def merge_dumps(dumps: Iterable[Mapping[str, Any]]) -> Dict[str, Any]:
        """Fold worker dumps into one fleet view.

        Counters and gauges sum (gauges here are point-in-time per-worker
        readings like queue depth, so the fleet value is the total);
        histograms merge bucket-wise, conserving counts exactly.
        """
        counters: Dict[str, int] = {}
        gauges: Dict[str, float] = {}
        hist_maps: List[Mapping[str, Mapping[str, Any]]] = []
        for d in dumps:
            for k, v in d.get("counters", {}).items():
                counters[k] = counters.get(k, 0) + int(v)
            for k, v in d.get("gauges", {}).items():
                gauges[k] = gauges.get(k, 0.0) + float(v)
            hist_maps.append(d.get("histograms", {}))
        return {
            "counters": dict(sorted(counters.items())),
            "gauges": dict(sorted(gauges.items())),
            "histograms": dict(
                sorted(_hist.merge_state_maps(hist_maps).items())
            ),
        }

    @classmethod
    def from_env(
        cls, environ: Optional[Mapping[str, str]] = None
    ) -> Optional["MetricsRegistry"]:
        """A live registry iff :data:`OBS_ENV_VAR` is truthy, else ``None``
        (the disabled path — every site sees ``None`` and does nothing)."""
        return cls() if env_enabled(environ) else None


def _prom_name(name: str) -> str:
    out = []
    for ch in name:
        out.append(ch if ch.isalnum() or ch == "_" else "_")
    s = "".join(out)
    return "repro_" + s


def dump_to_prometheus(dump: Mapping[str, Any]) -> str:
    """Prometheus text exposition of a registry dump (or fleet merge).

    Histograms become the standard cumulative ``_bucket{le=...}`` series
    over the power-of-two upper bounds, plus ``_count``; counters and
    gauges map directly.
    """
    lines: List[str] = []
    for name, v in dump.get("counters", {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} counter")
        lines.append(f"{pn} {int(v)}")
    for name, v in dump.get("gauges", {}).items():
        pn = _prom_name(name)
        lines.append(f"# TYPE {pn} gauge")
        lines.append(f"{pn} {float(v):g}")
    for name, st in dump.get("histograms", {}).items():
        pn = _prom_name(name)
        counts = [int(c) for c in st["counts"]]
        lines.append(f"# TYPE {pn} histogram")
        cum = 0
        for i, c in enumerate(counts):
            if not c:
                continue
            cum += c
            le = _hist.bucket_upper_bound(i)
            lines.append(f'{pn}_bucket{{le="{le}"}} {cum}')
        total = sum(counts)
        lines.append(f'{pn}_bucket{{le="+Inf"}} {total}')
        lines.append(f"{pn}_count {total}")
        lines.append(f"{pn}_max_ns {int(st.get('max_ns', 0))}")
    return "\n".join(lines) + ("\n" if lines else "")
