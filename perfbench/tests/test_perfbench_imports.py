"""What the benchmark runs imports neither JAX nor the JAX package, and
its reference imports nothing of the program; top-level module names are
compared whole (``repro_torch`` begins with ``repro``)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported(path: Path) -> set:
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


FILES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    BENCH)))
def test_no_jax_and_no_jax_package(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob(
    "*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"repro_torch", "repro"}
    assert not any(t == "perfbench" for t in imported(path))


def test_whole_names_are_compared():
    from perfbench.harness.bench import loaded_forbidden
    import repro_torch  # noqa: F401  (begins with "repro", is not it)
    assert "repro" not in loaded_forbidden()


def test_a_run_loads_none_of_them():
    code = (
        "import sys, torch; sys.path[:0] = [%r, %r, %r]\n"
        "import small\n"
        "from perfbench.harness import bench\n"
        "ctx = small.ctx('x', 5, 0.3, torch.device('cpu'), small.DENSE, "
        "small.mix('chat', **small.CHAT), {'widest_gap': 9.0})\n"
        "bench.drive(ctx)\n"
        "print(bench.loaded_forbidden())\n"
        % (str(ROOT), str(ROOT / "src"), str(BENCH / "tests")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_no_result_without_the_program(tmp_path):
    import shutil
    shutil.copytree(BENCH, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text(
        (ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "chameleon-34b.chat", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
