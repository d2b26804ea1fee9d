"""Benchmark orchestrator of the port — config-driven experiments over the
paper's sections, on the card.

The entry point is an experiment config::

    python -m repro_torch.benchmarks.run \\
        --experiment src/repro_torch/benchmarks/experiments/ci-smoke.json \\
        [--json-dir DIR] [--device cuda|cpu]

which loads a :class:`repro_torch.bench.ExperimentSpec` (the reference's
configs under ``benchmarks/experiments/`` load too) and runs every leg on
``--device`` (default ``cuda``; without CUDA that raises, so a number is
never a CPU number by accident), writing ``BENCH_<section>.json`` per
section (schema: :mod:`repro_torch.bench.reporting`; default directory
``$BENCH_JSON_DIR``, else ``bench-artifacts/torch/``) plus ``name,...``
CSV lines.  Sections:
  hier            — paper Figs. 4/5: update rate vs number and spacing of cuts
  scaling         — paper Fig. 6 shape, the K axis: aggregate rate vs packed
                    instances K on one card (the D axis waits for the mesh)
  kernels         — the four kernels alone: time, plain version, byte bound
  embed           — LM integration: hierarchical embedding-gradient window
  cascade_kernel  — the lane-skipping hier_cascade kernel vs the branchless
                    packed engine: per-step cost vs cascade frequency x K
  serve           — served rate vs raw-engine rate (feed_efficiency verdict)
  fleet           — aggregate served rate vs worker processes
                    (fleet_scaling verdict, record conservation)
  query           — ingest cost of live queries (query_cost verdict)
  obs             — cost of the metrics plane (obs_overhead verdict)
"""
import argparse
import os

from repro_torch.bench.experiments import (  # noqa: F401  (SECTIONS re-exported)
    SECTIONS,
    ExperimentError,
    ExperimentSpec,
    run_spec,
)
from repro_torch.device import resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run")
    ap.add_argument("--experiment", required=True, metavar="CONFIG",
                    help="experiment config (JSON or TOML) defining the legs to run")
    ap.add_argument("--json-dir", default=None,
                    help="directory for BENCH_<section>.json (default: "
                         "$BENCH_JSON_DIR, else bench-artifacts/torch/)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where every section runs (default: the card)")
    args = ap.parse_args(argv)
    if args.json_dir:
        os.environ["BENCH_JSON_DIR"] = args.json_dir
    try:
        spec = ExperimentSpec.from_file(args.experiment)
    except ExperimentError as e:
        raise SystemExit(str(e))
    device = str(resolve_device(args.device))
    run_spec(spec, json_dir=args.json_dir, device=device)


if __name__ == "__main__":
    main()
