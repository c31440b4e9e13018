"""Nothing of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port: by an AST scan of every file, and
in a fresh interpreter that loads the whole benchmark and the port's
entry. Top-level module names are compared whole: ``rabit_tpu_torch`` is
the port, ``rabit_tpu`` the JAX package."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "rabit_tpu"}


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


FILES = sorted(PB.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(PB)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not FORBIDDEN & set(_imports(path))


def test_the_scan_compares_whole_names():
    assert "rabit_tpu_torch" not in FORBIDDEN
    assert "rabit_tpu_torch".split(".")[0] != "rabit_tpu"


def test_the_reference_imports_nothing_of_the_port():
    ref = PB / "reference.py"
    assert set(_imports(ref)) <= {"__future__", "typing", "torch"}
    assert "histogram_reference" not in ref.read_text()
    assert "host_histogram" not in ref.read_text()


def test_only_rank_imports_the_port():
    users = {p.name for p in FILES if p.parent == PB
             and "rabit_tpu_torch" in set(_imports(p))}
    assert users == {"rank.py"}


def test_a_fresh_interpreter_loads_no_jax():
    code = (
        "import sys, importlib, pkgutil, perfbench\n"
        "for m in pkgutil.iter_modules(perfbench.__path__):\n"
        "    importlib.import_module('perfbench.' + m.name)\n"
        "import rabit_tpu_torch.models.histogram\n"
        "from perfbench.rank import forbidden_modules\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}"
        " & {'jax', 'jaxlib', 'flax', 'rabit_tpu'}), forbidden_modules())\n")
    done = subprocess.run([sys.executable, "-c", code], cwd=PB.parent,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode == 0, done.stderr
    assert done.stdout.strip().splitlines()[-1] == "[] []"
