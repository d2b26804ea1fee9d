"""``repro_torch.bench`` — the perf-observability plane of the port (port of
``repro.bench``, with the same public names).

* :mod:`~repro_torch.bench.models` — schema-versioned measurement models
  (``Measurement`` / ``SectionRun`` / ``RunRecord``), the reference's schema;
* :mod:`~repro_torch.bench.reporting` — the ``BENCH_<section>.json`` writer
  every ``repro_torch.benchmarks.bench_*`` uses; its host info names the
  device, the torch and CUDA versions and, on the card, the card's name and
  power limit;
* :mod:`~repro_torch.bench.parsers` — sweep artifact trees into one
  normalized :class:`RunRecord`;
* :mod:`~repro_torch.bench.history` — the port's own perf-history file
  (``src/repro_torch/benchmarks/history/perf_history.jsonl``), apart from
  the reference's, so card runs never trend against its CPU runs;
* :mod:`~repro_torch.bench.gate` — the trend gate (warn >10% / fail >30%
  below the rolling median; verdict true->false fails; empty history = clean
  baseline-established pass);
* :mod:`~repro_torch.bench.experiments` — config-driven multi-leg
  experiments (``python -m repro_torch.benchmarks.run --experiment``);
* :mod:`~repro_torch.bench.report` and :mod:`~repro_torch.bench.dashboard` —
  ``BENCH_report.{json,md}`` and its static HTML dashboard.

Artifacts from either package load in both: the schema is one.
"""
from .models import (  # noqa: F401
    HISTORY_SCHEMA_VERSION,
    SECTION_SCHEMA_VERSION,
    Measurement,
    ModelError,
    NormalizedMeasurement,
    RunRecord,
    SectionRun,
    params_key,
)
from .reporting import BenchmarkReport, git_branch, git_commit_hash  # noqa: F401
from .parsers import (  # noqa: F401
    find_bench_files,
    leg_label,
    normalize_dir,
    normalize_run,
    parse_section_file,
    sweep_section_runs,
)
from .history import (  # noqa: F401
    DEFAULT_HISTORY_RELPATH,
    append_fresh_artifacts,
    append_run,
    default_history_path,
    load_history,
)
from .gate import GateFinding, GateResult, gate_run, load_measurements  # noqa: F401
from .experiments import (  # noqa: F401
    SECTIONS,
    ExperimentError,
    ExperimentLeg,
    ExperimentSpec,
    run_spec,
    validate_leg_params,
)
from .report import (  # noqa: F401
    RateSeries,
    build_series,
    measurement_dims,
    report_markdown,
    report_payload,
    write_report,
)

__all__ = [
    "BenchmarkReport",
    "DEFAULT_HISTORY_RELPATH",
    "ExperimentError",
    "ExperimentLeg",
    "ExperimentSpec",
    "GateFinding",
    "GateResult",
    "HISTORY_SCHEMA_VERSION",
    "Measurement",
    "ModelError",
    "NormalizedMeasurement",
    "RateSeries",
    "RunRecord",
    "SECTIONS",
    "SECTION_SCHEMA_VERSION",
    "SectionRun",
    "append_fresh_artifacts",
    "append_run",
    "build_series",
    "default_history_path",
    "find_bench_files",
    "gate_run",
    "git_branch",
    "git_commit_hash",
    "leg_label",
    "load_history",
    "load_measurements",
    "measurement_dims",
    "normalize_dir",
    "normalize_run",
    "params_key",
    "parse_section_file",
    "report_markdown",
    "report_payload",
    "run_spec",
    "sweep_section_runs",
    "validate_leg_params",
    "write_report",
]
