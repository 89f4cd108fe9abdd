"""What the benchmark may load: no module of JAX or of the JAX package
anywhere under ``perfbench/`` (top-level names compared whole, so the
port's ``repro_torch`` passes and ``repro`` does not), nothing read from
``benchmarks/``, and nothing of the program in the plain references."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from perfbench import harness

PERFBENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in PERFBENCH.rglob("*.py")
                 if "__pycache__" not in p.parts)


def imported_tops(path: Path) -> set:
    tree = ast.parse(path.read_text(), str(path))
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            tops.add(str(node.args[0].value).split(".")[0])
    return tops


def test_the_check_compares_whole_names():
    assert "repro" in harness.FORBIDDEN_TOP
    assert "repro_torch".split(".")[0] not in harness.FORBIDDEN_TOP


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(PERFBENCH)) for p in SOURCES])
def test_no_jax_and_no_jax_package(path):
    assert not imported_tops(path) & set(harness.FORBIDDEN_TOP)
    assert "benchmarks" not in imported_tops(path)
    if path != Path(__file__).resolve():       # this file names them
        text = path.read_text()
        assert "benchmarks/" not in text and "BENCH_history" not in text


@pytest.mark.parametrize("path", sorted((PERFBENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_take_nothing_of_the_program(path):
    tops = imported_tops(path)
    assert "repro_torch" not in tops
    assert tops <= {"__future__", "math", "torch", "perfbench"}
    text = path.read_text()
    assert "repro_torch" not in text


def test_a_run_loads_no_jax():
    """A whole smoke run in a fresh process leaves no forbidden module
    loaded."""
    code = ("from perfbench.tests import smoke; from perfbench import "
            "harness; smoke.run('smoke.batch'); "
            "print(harness.forbidden_modules())")
    root = PERFBENCH.parent
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600, cwd=root,
                       env={"PYTHONPATH": f"{root}:{root / 'src'}",
                            "PATH": "/usr/bin:/bin"})
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
