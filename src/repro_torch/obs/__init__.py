"""repro_torch.obs — runtime observability plane (port of ``repro.obs``).

Low-overhead metrics (counters / gauges / log-bucketed latency
histograms), a bounded trace ring, and the enable plumbing shared by the
serve and fleet stacks.  Off by default: sites hold ``None`` and cost one
``is not None`` check (the ``repro_torch.faults`` zero-overhead contract).
Enable with ``ServeConfig(metrics=True)`` or ``REPRO_OBS=1``.
"""
from repro_torch.obs.hist import (
    NUM_BUCKETS,
    LatencyHistogram,
    bucket_index,
    bucket_upper_bound,
    merge_state_maps,
    merge_states,
    state_count,
    state_percentile,
    summarize_state,
)
from repro_torch.obs.registry import (
    OBS_ENV_VAR,
    Counter,
    Gauge,
    MetricsRegistry,
    dump_to_prometheus,
    env_enabled,
)
from repro_torch.obs.trace import TraceRing, torch_profile

__all__ = [
    "NUM_BUCKETS",
    "LatencyHistogram",
    "bucket_index",
    "bucket_upper_bound",
    "merge_state_maps",
    "merge_states",
    "state_count",
    "state_percentile",
    "summarize_state",
    "OBS_ENV_VAR",
    "Counter",
    "Gauge",
    "MetricsRegistry",
    "dump_to_prometheus",
    "env_enabled",
    "TraceRing",
    "torch_profile",
]
