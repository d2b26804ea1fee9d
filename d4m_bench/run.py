"""Run one cell of the D4M benchmark once, on the card.

    python3 d4m_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up (the kernels' build into
``d4m_bench/.build/``, the stream drawn on the card from ``--seed``, the
session, one warm-up epoch), then ``--seconds`` of measurement, then the
comparison with the plain reference.  The last line of standard output is
one JSON object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics, or with ``--trace 1`` its per-layer ones),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``: each
number compared with its limit, also the last lines of standard error.
Without a CUDA device, or with fewer than the cell asks for, it exits 2 and
prints no result.
"""
from __future__ import annotations

import time

T_PERF = time.perf_counter()

import argparse
import json
import os
import sys
from pathlib import Path


def _since_process_start() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, AttributeError):
        return 0.0


def main(argv=None) -> int:
    t_start = T_PERF - max(0.0, _since_process_start() - (time.perf_counter() - T_PERF))
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parents[1]
    # the kernels build into one fixed directory of the checkout, so that only
    # a cell's first run there compiles
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(root / "d4m_bench" / ".build")
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path[:0] = [str(root), str(root / "src")]

    from d4m_bench import harness

    cell = harness.load_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        harness.log(f"needs {chips} CUDA device(s), found {n}: no result")
        return 2
    torch.set_num_threads(1)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start=t_start)
    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"modules that must not be loaded are loaded: {bad}: no result")
        return 3
    for name, c in result["compared"].items():
        harness.log(f"compared {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
