"""The paper's own workload: Graph500 R-MAT power-law edge streams into
hierarchical associative arrays (100 M edges in 100 K-edge groups).
A copy of ``repro.configs.d4m_stream`` for the port.

This is the *workload* config (stream shape + R-MAT parameters); the
*session* config is :class:`repro_torch.d4m.StreamConfig`, and
:meth:`WorkloadConfig.to_session` bridges the two.
"""
import dataclasses
import warnings


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    scale: int = 20  # R-MAT scale: 2**scale vertices
    total_edges: int = 100_000_000
    group_size: int = 100_000
    cuts: tuple = (100_000, 1_000_000, 10_000_000)  # paper Fig. 3 style schedule
    top_capacity: int = 140_000_000
    a: float = 0.57
    b: float = 0.19
    c: float = 0.19  # R-MAT probabilities (Graph500)
    seed: int = 0

    def to_session(self, **overrides):
        """The matching :class:`repro_torch.d4m.StreamConfig`."""
        from repro_torch.d4m import StreamConfig

        kw = dict(
            cuts=self.cuts,
            top_capacity=self.top_capacity,
            batch_size=self.group_size,
            seed=self.seed,
        )
        kw.update(overrides)
        return StreamConfig(**kw)


def __getattr__(name):
    # The reference's backwards-compatible alias: ``StreamConfig`` from here
    # hands back WorkloadConfig, with the reference's warning.
    if name == "StreamConfig":
        warnings.warn(
            "repro.configs.d4m_stream.StreamConfig is deprecated: the "
            "workload config here is WorkloadConfig; the session config is "
            "repro.d4m.StreamConfig",
            DeprecationWarning,
            stacklevel=2,
        )
        return WorkloadConfig
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


CONFIG = WorkloadConfig()

# CPU-bench variant (same structure, laptop-scale)
BENCH = WorkloadConfig(
    scale=16, total_edges=2_000_000, group_size=20_000,
    cuts=(20_000, 200_000), top_capacity=3_000_000,
)
