"""Nothing the benchmark runs imports JAX or the JAX package, judged by
whole top-level module names (``stabstitch2_tpu_torch`` begins with
``stabstitch2_tpu`` and is the program), and nothing under ``benchmark/``
reads the JAX package's benchmark (``bench.py``, ``BENCH_*``,
``MULTICHIP_*``, ``BENCHMARKS.md``, ``BASELINE.json``)."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

from benchmark.harness import FORBIDDEN, forbidden_modules

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SOURCES = sorted(glob.glob(os.path.join(ROOT, "benchmark", "**", "*.py"),
                           recursive=True))
OLD_BENCH = ("bench.py", "BENCH_", "MULTICHIP_", "BENCHMARKS.md",
             "BASELINE.json")


def imported(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_whole_top_level_names():
    assert forbidden_modules(["stabstitch2_tpu_torch.cli", "numpy"]) == []
    assert forbidden_modules(["stabstitch2_tpu.ops.tps"]) == [
        "stabstitch2_tpu"]
    assert forbidden_modules(["jax._src.core", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib"]


def test_no_source_imports_jax_or_the_jax_package():
    assert SOURCES
    for path in SOURCES:
        bad = forbidden_modules(imported(path))
        assert not bad, f"{path} imports {bad}"


def test_no_source_reads_the_old_benchmark():
    for path in SOURCES:
        if path == os.path.abspath(__file__):
            continue
        text = open(path).read()
        assert not [s for s in OLD_BENCH if s in text], path


def test_a_run_loads_no_jax():
    """Every module of the harness, its drivers, readers, reference and
    control, and the program modules they drive, imported in a fresh
    interpreter whose path holds the checkout alone."""
    code = (
        "import glob, importlib, os, sys\n"
        "from benchmark import harness, control\n"
        "import stabstitch2_tpu_torch.cli, stabstitch2_tpu_torch.pipeline"
        ".online, stabstitch2_tpu_torch.pipeline.threeview\n"
        "import stabstitch2_tpu_torch.train.spatial, stabstitch2_tpu_torch"
        ".data.datasets\n"
        "for kind in ('drivers', 'metrics'):\n"
        "    for p in glob.glob(os.path.join('benchmark', kind, '*.py')):\n"
        "        harness.load_module(p, 'm_' + os.path.basename(p)"
        ".replace('.', '_'))\n"
        "print(harness.forbidden_modules(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    assert set(FORBIDDEN) == {"jax", "jaxlib", "flax", "stabstitch2_tpu"}
