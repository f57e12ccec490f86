"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the program (top-level names compared
whole: ``eda_dm_tpu_torch`` is not ``eda_dm_tpu``)."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "eda_dm_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert not top_level_imports(path) & (FORBIDDEN | {"eda_dm_tpu_torch", "benchmark"})


def test_names_compared_whole():
    from benchmark.run import FORBIDDEN as RUN_FORBIDDEN, loaded_forbidden
    assert set(RUN_FORBIDDEN) == FORBIDDEN
    import eda_dm_tpu_torch  # noqa: F401  (a prefix of no forbidden name counts)
    assert "eda_dm_tpu_torch" not in loaded_forbidden()
