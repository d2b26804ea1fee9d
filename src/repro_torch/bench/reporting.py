"""Structured benchmark output: ``BENCH_<section>.json`` alongside the CSV
(port of ``repro.bench.reporting``, on the reference's schema).

One run record with git/host provenance plus a flat ``measurements`` list,
so the port's parsers, history, gate, report and dashboard (and the
reference's, which read the same schema) take it unchanged::

    {
      "schema_version": 1,
      "section": "scaling",
      "git_commit_hash": "<sha or 'unknown'>",
      "git_branch": "<branch or 'unknown'>",
      "run_start_ts": "2026-07-30T12:00:00+00:00",
      "run_end_ts": "...",
      "host": {"hostname": ..., "backend": "cuda", "device_count": 1,
               "torch_version": "2.11.0+cu128", "cuda_version": "12.8",
               "device_name": "NVIDIA H100 80GB HBM3",
               "power_limit": "700.00 W"},
      "ci_run_id": "1234567890",        # GITHUB_RUN_ID; absent locally
      "measurements": [
        {"name": "packed_scaling", "params": {"k_per_device": 8, ...},
         "updates_per_sec": 1.2e7, "wall_s": 0.41, ...extras}
      ]
    }

The host names the device the run used (``backend``: ``"cuda"`` or
``"cpu"``) and, on the card, its name and power limit as ``nvidia-smi``
reports them, so a number is never read without its hardware.  No
``jax_version`` is written.

Every ``repro_torch.benchmarks.bench_*.main`` builds a
:class:`BenchmarkReport` on its device, ``add()``s one measurement per CSV
line it prints, and ``write()``s on exit.  The output directory is
``--json-dir`` (environment variable ``BENCH_JSON_DIR``); by default
``bench-artifacts/torch/`` under the working directory, so a run from the
repository root never overwrites the tracked ``BENCH_scaling.json``.
"""
from __future__ import annotations

import dataclasses
import json
import os
import platform
import subprocess
from datetime import datetime, timezone
from typing import Any, Dict, List

import torch

from .models import SECTION_SCHEMA_VERSION as SCHEMA_VERSION  # noqa: F401

#: where ``write()`` puts artifacts when neither an argument nor
#: ``BENCH_JSON_DIR`` names a directory (git-ignored through bench-artifacts/)
DEFAULT_JSON_DIR = os.path.join("bench-artifacts", "torch")


def _git(*args: str) -> str:
    try:
        out = subprocess.run(
            ["git", *args],
            cwd=os.path.dirname(os.path.abspath(__file__)),
            capture_output=True,
            text=True,
            timeout=10,
        )
        if out.returncode == 0:
            return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        pass
    return ""


def git_commit_hash() -> str:
    return os.environ.get("GITHUB_SHA") or _git("rev-parse", "HEAD") or "unknown"


def git_branch() -> str:
    """The branch the run measures, robust to detached/CI checkouts:
    ``GITHUB_REF_NAME`` wins; a detached checkout's literal ``HEAD`` is not a
    branch and reads as ``unknown``."""
    env = os.environ.get("GITHUB_REF_NAME")
    if env:
        return env
    branch = _git("rev-parse", "--abbrev-ref", "HEAD")
    if branch and branch != "HEAD":
        return branch
    return "unknown"


def _now() -> str:
    return datetime.now(timezone.utc).isoformat(timespec="seconds")


def card_power_limit() -> str:
    """The card's power limit as ``nvidia-smi`` reports it (e.g.
    ``"700.00 W"``), or ``"unknown"`` where it cannot be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.SubprocessError):
        return "unknown"
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        return "unknown"
    return lines[0].rsplit(",", 1)[-1].strip()


def _host_info(device: str | None) -> Dict[str, Any]:
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    info: Dict[str, Any] = {
        "hostname": platform.node(),
        "platform": platform.platform(),
        "python": platform.python_version(),
        "torch_version": torch.__version__,
        "cuda_version": torch.version.cuda,
        "backend": dev.type,
    }
    if dev.type == "cuda":
        info["device_count"] = torch.cuda.device_count()
        info["device_name"] = torch.cuda.get_device_name(dev)
        info["power_limit"] = card_power_limit()
    else:
        info["device_count"] = 1
        info["device_name"] = "cpu"
    return info


@dataclasses.dataclass
class BenchmarkReport:
    """Collects one section's measurements and serializes them to JSON.
    ``device`` is the device the section ran on, which the host info names
    (``None``: the card where there is one, else the CPU)."""

    section: str
    measurements: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    run_start_ts: str = dataclasses.field(default_factory=_now)
    device: str | None = None

    def add(
        self,
        name: str,
        params: Dict[str, Any] | None = None,
        updates_per_sec: float | None = None,
        wall_s: float | None = None,
        **extra: Any,
    ) -> None:
        m: Dict[str, Any] = {"name": name, "params": dict(params or {})}
        if updates_per_sec is not None:
            m["updates_per_sec"] = float(updates_per_sec)
        if wall_s is not None:
            m["wall_s"] = float(wall_s)
        m.update(extra)
        self.measurements.append(m)

    def payload(self) -> Dict[str, Any]:
        payload = {
            "schema_version": SCHEMA_VERSION,
            "section": self.section,
            "git_commit_hash": git_commit_hash(),
            "git_branch": git_branch(),
            "run_start_ts": self.run_start_ts,
            "run_end_ts": _now(),
            "host": _host_info(self.device),
            "measurements": self.measurements,
        }
        ci_run_id = os.environ.get("GITHUB_RUN_ID")
        if ci_run_id:
            payload["ci_run_id"] = ci_run_id
        return payload

    def write(self, out_dir: str | None = None) -> str:
        """Write ``BENCH_<section>.json``; returns the path written."""
        out_dir = out_dir or os.environ.get("BENCH_JSON_DIR") or DEFAULT_JSON_DIR
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"BENCH_{self.section}.json")
        with open(path, "w") as f:
            json.dump(self.payload(), f, indent=2)
            f.write("\n")
        print(f"json,section={self.section},path={path}", flush=True)
        return path
