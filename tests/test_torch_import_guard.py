"""The port stands alone: ``repro_torch``, ``chip_smoke.py`` and
``chip_compare.py`` import neither ``jax`` nor the reference package
``repro``."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"

_CHILD = r"""
import importlib, pkgutil, sys
sys.modules["jax"] = None  # any "import jax" now raises ImportError
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m == "repro" or m.startswith("repro."))
assert not leaked, leaked
for name in ("repro_torch.kernels.merge_add.ops", "repro_torch.kernels.sort_dedup.ops",
             "repro_torch.d4m.algebra", "repro_torch.core.analytics",
             "repro_torch.kernels.scatter_add.ops", "repro_torch.sparse.row_accum",
             "repro_torch.sparse.hier_grad", "repro_torch.sparse.convert",
             "repro_torch.optim.adamw",
             "repro_torch.data.tokens", "repro_torch.models.config",
             "repro_torch.configs.granite_3_8b",
             "repro_torch.faults.plan", "repro_torch.faults.retry",
             "repro_torch.obs.hist", "repro_torch.obs.registry", "repro_torch.obs.trace",
             "repro_torch.checkpoint.manager",
             "repro_torch.serve.wire", "repro_torch.serve.router", "repro_torch.serve.sources",
             "repro_torch.serve.query", "repro_torch.serve.server",
             "repro_torch.fleet.routing", "repro_torch.fleet.worker",
             "repro_torch.fleet.controller",
             "repro_torch.runtime.elastic", "repro_torch.runtime.straggler",
             "repro_torch.bench", "repro_torch.bench.models", "repro_torch.bench.reporting",
             "repro_torch.bench.parsers", "repro_torch.bench.history", "repro_torch.bench.gate",
             "repro_torch.bench.experiments", "repro_torch.bench.report",
             "repro_torch.bench.dashboard", "repro_torch.benchmarks", "repro_torch.benchmarks.run",
             "repro_torch.benchmarks.bench_hier_update", "repro_torch.benchmarks.bench_kernels",
             "repro_torch.benchmarks.bench_cascade_kernel", "repro_torch.benchmarks.bench_scaling",
             "repro_torch.benchmarks.bench_embed_grad", "repro_torch.benchmarks.bench_serve",
             "repro_torch.benchmarks.bench_query", "repro_torch.benchmarks.bench_obs",
             "repro_torch.benchmarks.bench_fleet"):
    assert name in names, name
print(len(names))
"""

# "import jax", "from jax...", "import repro[.x]", "from repro[.x] import";
# repro_torch itself is allowed
_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)(\.|\s|,|$)", re.M)


def test_every_module_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", _CHILD], env=env, capture_output=True, text=True, timeout=120
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip().splitlines()[-1]) >= 90


def test_no_source_names_jax_or_repro():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "chip_compare.py"]
    assert len(files) > 15
    for f in files:
        src = f.read_text()
        hits = [m.group(0).strip() for m in _FORBIDDEN.finditer(src)]
        assert not hits, (str(f.relative_to(ROOT)), hits)


def test_controller_spawns_the_port_worker():
    """The source regex above does not see a module named inside a string:
    the fleet controller must spawn the port's worker, never the
    reference's."""
    src = (PORT / "fleet" / "controller.py").read_text()
    spawned = re.findall(r'"-m",\s*"([\w.]+)"', src)
    assert spawned == ["repro_torch.fleet.worker"], spawned
    assert not re.search(r'["\']repro\.', src)


def test_bench_sections_are_the_ports():
    """The experiment runner names its sections in strings: every one must
    be a module of the port's ``benchmarks`` package, never the reference's."""
    from repro_torch.bench import experiments

    mods = experiments._SECTION_MODULES
    assert set(mods) == set(experiments.SECTIONS)
    assert all(m.startswith("repro_torch.benchmarks.bench_") for m in mods.values()), mods
    src = (PORT / "bench" / "experiments.py").read_text()
    assert not re.search(r'["\'](repro|benchmarks)\.bench', src)
