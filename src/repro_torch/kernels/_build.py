"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``.cu`` file under ``repro_torch/csrc`` with a plain C
interface, compiled for Hopper (``sm_90a``) into a shared library at first
use.  Libraries go to ``repro_torch/kernels/build/`` (listed in
``.gitignore``; ``REPRO_TORCH_BUILD_DIR`` overrides it), named by a hash of
the sources and flags, so an edited source is rebuilt and an unchanged one
is reused.  ``nvcc`` is found through ``CUDA_HOME`` or
``/usr/local/cuda/bin``.  A failed build raises: there is no fallback.

No ``--use_fast_math``: it changes NaN and denormal handling, and the
kernels are held bit-exactly to their plain versions.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parents[1] / "csrc"

#: kernel name -> its source under ``csrc`` (headers there are shared)
KERNELS = {
    "hier_cascade": "hier_cascade.cu",
    "merge_add": "merge_add.cu",
    "scatter_add": "scatter_add.cu",
    "sort_dedup": "sort_dedup.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: per kernel: the compiler's output (ptxas register/shared-memory report)
build_logs: Dict[str, str] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    env = os.environ.get("REPRO_TORCH_BUILD_DIR")
    return Path(env) if env else Path(__file__).resolve().parent / "build"


def find_nvcc() -> str:
    roots = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for root in roots:
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or install the CUDA toolkit under "
        "/usr/local/cuda (the port's kernels are built from source at first use)"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] | None = None) -> Dict[str, Path]:
    """Compile every named kernel that is not built yet, one ``nvcc`` per
    source, all started together.  Returns the library paths."""
    names = list(KERNELS if names is None else names)
    out: Dict[str, Path] = {}
    procs = {}
    for name in names:
        target = _target(name)
        out[name] = target
        if target.exists():
            continue
        target.parent.mkdir(parents=True, exist_ok=True)
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / KERNELS[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
        )
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out[name])  # atomic: a concurrent loader sees all or nothing
    if errors:
        raise RuntimeError("\n".join(errors))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    if name not in _libs:
        _libs[name] = ctypes.CDLL(str(build_all([name])[name]))
    return _libs[name]
