"""What the benchmark loads: never JAX or the JAX package, and in the
yardstick nothing of the program under test."""

from __future__ import annotations

import ast
import subprocess
import sys

from benchmark.tests.conftest import ROOT

YARDSTICK = sorted((ROOT / "benchmark" / "yardstick").glob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_the_yardstick_imports_nothing_of_the_program():
    assert YARDSTICK
    for path in YARDSTICK:
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"swinwnet_tpu_torch", "swinwnet_tpu", "jax", "flax"}, path


def test_no_benchmark_file_imports_jax():
    for path in (ROOT / "benchmark").rglob("*.py"):
        tops = {name.split(".")[0] for name in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "optax", "orbax", "swinwnet_tpu"}, path


def test_a_run_loads_no_jax():
    """A whole run of a tiny cell in a fresh process, then the check the
    command makes once its window has closed."""
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from benchmark.tests.conftest import run_tiny, tiny_cell\n"
        "from benchmark import harness\n"
        "r = run_tiny(tiny_cell('wnet-serve-b1'))\n"
        "print(harness.forbidden_modules(), r['attempted'] > 0)\n" % str(ROOT)
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    from benchmark import harness

    monkeypatch.setitem(sys.modules, "swinwnet_tpu_torch_like", sys)
    monkeypatch.setitem(sys.modules, "jaxfoo.bar", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "swinwnet_tpu.models", sys)
    assert harness.forbidden_modules() == ["swinwnet_tpu"]
