"""What the benchmark imports: nothing under benchmark/ imports JAX or the
JAX package, and benchmark/reference/ imports nothing of the program.
Modules are compared by their top-level name whole: the port's name
begins with the JAX package's."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
JAX = {"jax", "jaxlib", "flax", "spartacus_surface_tpu"}
PROGRAM = "spartacus_surface_tpu_torch"


def top_level_imports(path: Path) -> set:
    """The top-level names of the absolute imports of a source file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(BENCH.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    names = top_level_imports(path)
    assert PROGRAM not in names and not names & JAX
    assert names <= {"__future__", "contextlib", "dataclasses", "math", "numpy", "torch"}


def test_whole_names_are_compared():
    """A module of the port is not taken for the JAX package's."""
    assert "spartacus_surface_tpu_torch.models".split(".")[0] not in JAX
    assert top_level_imports(BENCH / "run.py") & JAX == set()
