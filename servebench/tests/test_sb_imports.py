"""Nothing the benchmark runs imports JAX or the JAX package, and the plain
references import nothing of the program either: module names are compared
by their top-level part, whole (``repro_torch`` is not ``repro``)."""
import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
FILES = sorted(p for p in HERE.rglob("*.py") if "tests" not in p.parts)


def imported(path: Path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_or_jax_package(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro"}


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not imported(path) & {"jax", "jaxlib", "flax", "repro", "repro_torch"}


def test_the_scan_sees_a_planted_import(tmp_path):
    p = tmp_path / "x.py"
    p.write_text("import repro.core\nfrom jax import numpy\nimport repro_torch\n")
    assert imported(p) == {"repro", "jax", "repro_torch"}


def test_run_refuses_a_process_that_loaded_them(monkeypatch):
    import sys

    import run
    monkeypatch.setitem(sys.modules, "repro", object())
    assert run.forbidden_modules() == ["repro"]
