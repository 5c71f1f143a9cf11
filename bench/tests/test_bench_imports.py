"""No module of the benchmark imports jax, ml_dtypes or the JAX package
``repro`` (top-level names compared whole: ``repro_torch`` begins with
``repro``), and the reference imports nothing of the program."""
import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ml_dtypes", "repro"}


def top_level_imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(BENCH)) for p in BENCH.rglob("*.py")))
def test_no_jax_or_jax_package_import(path):
    assert not top_level_imports(BENCH / path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(BENCH)) for p in (BENCH / "reference").rglob("*.py")))
def test_the_reference_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(BENCH / path)


def test_the_whole_name_is_compared():
    assert "repro_torch" not in FORBIDDEN
    assert "repro_torch".split(".")[0] != "repro"
