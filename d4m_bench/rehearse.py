"""Rehearse a cell on the CPU before a call to the card.

    python3 d4m_bench/rehearse.py --workload <name> [--seed N] [--seconds S] [--trace 0|1]

Runs the cell's set-up, its window and the comparison with the plain
reference through the same code as ``run.py``, at a tiny size
(``harness.shrink``) on the CPU, where the port runs its kernels' plain
versions.  It prints the counts of the window and every number compared
with its limit, and no metric: a CPU run measures nothing of the card.
Exits 1 when the comparison fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path[:0] = [str(root), str(root / "src")]

    from d4m_bench import harness

    cell = harness.shrink(harness.load_cell(args.workload))
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device="cpu")
    out = {"correct": result["correct"], "attempted": result["attempted"], "failed": result["failed"],
           "counts": result["counts"], "compared": result["compared"],
           "forbidden_modules": harness.forbidden_modules()}
    print(json.dumps(out))
    return 0 if result["correct"] and not out["forbidden_modules"] else 1


if __name__ == "__main__":
    sys.exit(main())
