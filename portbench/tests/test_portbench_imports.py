"""No module of the benchmark imports JAX, the JAX package or the root
``benchmarks`` (top-level names compared whole: ``conan_slam_tpu_torch``
is the program and is allowed), and the reference imports nothing of the
program."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

BENCH = Path(__file__).resolve().parents[1]
SOURCES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.parts)


def top_level_imports(path: Path) -> set[str]:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not top_level_imports(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_plain(path):
    assert top_level_imports(path) <= {"__future__", "itertools", "math", "contextlib",
                                       "dataclasses", "torch", "numpy"}


def test_names_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "conan_slam_tpu_torch_lookalike", sys)
    assert "conan_slam_tpu" not in harness.loaded_forbidden()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert "jax" in harness.loaded_forbidden()

