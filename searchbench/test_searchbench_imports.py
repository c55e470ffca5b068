"""Nothing the benchmark runs imports JAX or the JAX package, judged by
each imported module's top-level name as a whole word; the reference
imports nothing of the port either."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "namazu_tpu"}


def _imported(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources():
    return sorted(p for p in HERE.rglob("*.py")
                  if not p.name.startswith("test_"))


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_no_jax(path):
    assert not set(_imported(path)) & FORBIDDEN


@pytest.mark.parametrize(
    "path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_port(path):
    assert not set(_imported(path)) & (FORBIDDEN | {"namazu_tpu_torch"})


def test_whole_names():
    # the port's name begins with the JAX package's: a prefix match
    # would refuse it, a whole-name match does not
    assert "namazu_tpu_torch".split(".")[0] not in FORBIDDEN
