"""No module of the benchmark imports JAX, flax, optax or the JAX package, nor
cv2, PIL or matplotlib (absent on the card's machine), by whole top-level name;
the reference imports nothing of the port."""

import ast
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rgbdseg_tpu", "cv2", "PIL", "matplotlib"}
FILES = sorted(p for p in BENCH.rglob("*.py") if "tests" not in p.relative_to(BENCH).parts)


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_forbidden_import(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "rgbdseg_torch" not in top_level_imports(path)


def test_whole_names_are_compared():
    """`rgbdseg_torch` is not `rgbdseg_tpu`, though one name starts with the other's prefix."""
    assert "rgbdseg_torch" not in FORBIDDEN and {"rgbdseg_torch"} & FORBIDDEN == set()
    assert top_level_imports(BENCH / "harness.py") & {"rgbdseg_tpu"} == set()
