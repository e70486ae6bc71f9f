"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the system under test.  Names are compared
by their top-level part (before the first dot), whole: the system's name
begins with the JAX package's."""

import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "voicepuppet_tpu"}


def imported(path: Path):
    """Every module name a file imports, whole."""
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def imported_tops(path: Path):
    return {name.split(".", 1)[0] for name in imported(path)}


SOURCES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(
    ROOT)))
def test_no_jax_in_the_benchmark(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_system(path):
    tops = set(imported_tops(path))
    assert "voicepuppet_torch" not in tops
    assert not tops & FORBIDDEN
    assert tops <= {"__future__", "math", "random", "statistics", "typing",
                    "numpy", "torch", "benchmark", "PIL"}
    # of the benchmark, the reference reads only the reference
    assert all(n.startswith("benchmark.reference") for n in imported(path)
               if n.split(".", 1)[0] == "benchmark")


def test_the_harness_loads_no_jax_after_a_run():
    """A CPU run of a cell at test size in a fresh process, then the
    top-level names of ``sys.modules``."""
    code = (
        "import json, time, sys\n"
        "sys.path.insert(0, %r)\n"
        "from benchmark import harness\n"
        "harness.fix_cache_dirs()\n"
        "from benchmark.tests.conftest import tiny_cell\n"
        "from benchmark.run import run_cell\n"
        "cell = tiny_cell('serve-batch-clips')\n"
        "run_cell(harness.Run(cell, 3, 0.5, False, 'cpu', "
        "time.perf_counter()))\n"
        "print(json.dumps(sorted({m.split('.', 1)[0] "
        "for m in sys.modules})))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "voicepuppet_torch" in tops
    assert not tops & FORBIDDEN


def test_the_harness_refuses_without_a_card_or_the_system(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark, and
    here without a card: a nonzero exit and no result line."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "serve-batch-clips", "--seed", str(2 ** 31 + 3), "--seconds", "1",
         "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
