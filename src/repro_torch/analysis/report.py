"""Render the port's dry-run JSONs (``launch.dryrun --out DIR``) into a
roofline table (port of ``repro.analysis.report``)."""
from __future__ import annotations

import json
import os
from typing import List

ARCH_ORDER = [
    "qwen2_0_5b", "whisper_tiny", "mamba2_1_3b", "paligemma_3b",
    "h2o_danube3_4b", "granite_3_8b", "phi3_5_moe", "gemma3_27b",
    "jamba_1_5_large", "deepseek_v3",
]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def load(outdir: str, mesh: str, tag: str = "") -> List[dict]:
    rows = []
    for arch in ARCH_ORDER:
        for shape in SHAPE_ORDER:
            f = os.path.join(outdir, f"{arch}x{shape}x{mesh}" + (f"x{tag}" if tag else "") + ".json")
            if os.path.exists(f):
                with open(f) as fh:
                    rows.append(json.load(fh))
    return rows


def fmt_ms(x):
    return f"{1e3 * x:.2f}"


def table(outdir: str = "experiments/dryrun", mesh: str = "single", tag: str = "") -> str:
    rows = load(outdir, mesh, tag)
    out = [
        "| arch | shape | strategy | status | t_comp ms | t_mem ms | t_coll ms | bottleneck "
        "| rMFU | useful | GB/dev | n_micro |",
        "|---|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for d in rows:
        if d["status"] == "skipped":
            out.append(f"| {d['arch']} | {d['shape']} | — | SKIP (no sub-quadratic path) "
                       f"| — | — | — | — | — | — | — | — |")
            continue
        if d["status"] != "planned":
            out.append(f"| {d['arch']} | {d['shape']} | {d.get('strategy', '—')} | **{d['status']}** "
                       f"| — | — | — | — | — | — | — | — |")
            continue
        r = d["roofline"]
        gb = d["memory"]["total_bytes_per_device"] / 2**30
        out.append(
            f"| {d['arch']} | {d['shape']} | {d['strategy']} | ok | {fmt_ms(r['t_compute_s'])} "
            f"| {fmt_ms(r['t_memory_s'])} | {fmt_ms(r['t_collective_s'])} "
            f"| {r['bottleneck']} | {r['roofline_mfu']:.3f} "
            f"| {r['useful_flops_ratio']:.2f} | {gb:.1f} | {d.get('n_micro', 1)} |"
        )
    return "\n".join(out)


if __name__ == "__main__":
    import sys

    print(table(sys.argv[1] if len(sys.argv) > 1 else "experiments/dryrun",
                mesh=sys.argv[2] if len(sys.argv) > 2 else "single"))
