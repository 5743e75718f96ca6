"""What the benchmark may load: nothing of JAX or of the JAX package
(compared by whole top-level names: ``repro_torch`` is the port, not
``repro``), and in the reference nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from portbench import harness

HERE = Path(__file__).resolve().parent
FILES = sorted(p for p in HERE.rglob("*.py") if "_cache" not in p.parts)
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module)
            names |= {f"{node.module}.{a.name}" for a in node.names}
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_module_imports_jax_or_the_jax_package(path):
    tops = {n.split(".")[0] for n in _imports(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top != "repro_torch"
        if top == "portbench":
            assert name.startswith("portbench.reference")


def test_no_file_names_the_jax_packages_benchmarks():
    for path in FILES:
        if path.name == Path(__file__).name:
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                assert "benchmarks/" not in node.value, path
                assert node.value != "benchmarks", path


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch.core", "reprox",
                                      "jax_free", "numpy"]) == []
    assert harness.forbidden_modules(["repro.core.imm", "jaxlib.xla",
                                      "flax"]) == ["flax", "jaxlib", "repro"]


def test_a_run_loads_no_jax():
    """A cell run on the CPU in a fresh process: afterwards no loaded
    module's top-level name is a forbidden one."""
    root = HERE.parent
    code = f"""
import sys, time
sys.path[:0] = [{str(root)!r}, {str(root / 'src')!r}]
import torch
torch.set_num_threads(1)
from portbench import conftest, harness
cell = conftest.small_cell("g500_lt.serve")
out = harness.run(cell, 11, 0.1, True, "cpu", time.perf_counter())
assert out["correct"], out
print("LOADED", harness.forbidden_modules())
"""
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300)
    assert done.returncode == 0, done.stderr[-2000:]
    assert "LOADED []" in done.stdout
