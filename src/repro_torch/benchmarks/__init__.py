"""The port's benchmark sections (port of the reference's ``benchmarks/``).

Each ``bench_<section>.py`` drives one measurement through the port's
public entry points on the card (``device="cpu"`` for tests) and writes
``BENCH_<section>.json`` on the reference's schema
(:mod:`repro_torch.bench.reporting`), with the kernels' launch counts of
each leg.  Run them through :mod:`repro_torch.benchmarks.run`::

    python -m repro_torch.benchmarks.run \\
        --experiment src/repro_torch/benchmarks/experiments/ci-smoke.json

The reference's ``benchmarks/`` folder, its specs and its history are
read-only inputs here: its specs load and run in the port, and the port's
history is its own file under ``history/``.
"""
