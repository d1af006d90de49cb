"""Nothing of the benchmark imports JAX or the JAX package, and its
reference imports nothing of the port; the run checks the same of its
own process (top-level module names compared whole: the port's name
begins with the JAX package's)."""

import ast
import sys
from pathlib import Path

import pytest

from portbench import harness

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "gansynth_tpu"}
FILES = sorted(p for p in harness.HERE.rglob("*.py")
               if "__pycache__" not in p.parts)


def imported(path: Path):
    """Every module a file imports, as written."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
            out |= {f"{node.module}.{a.name}" for a in node.names}
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", None) == "__import__":
            out |= {a.value for a in node.args[:1]
                    if isinstance(a, ast.Constant)}
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(harness.HERE)))
def test_no_jax(path):
    tops = {m.split(".")[0] for m in imported(path)}
    assert not tops & FORBIDDEN


@pytest.mark.parametrize("path", sorted((harness.HERE / "reference")
                                        .glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    for m in imported(path):
        top = m.split(".")[0]
        assert top != "gansynth_tpu_torch", m
        if top == "portbench":
            assert m.startswith("portbench.reference"), m


def test_names_are_compared_whole():
    sys.path.insert(0, str(harness.HERE))
    import run

    assert "gansynth_tpu_torch" not in run.FORBIDDEN
    sys.modules["gansynth_tpu.fake"] = sys.modules[__name__]
    try:
        assert run.forbidden_modules() == ["gansynth_tpu"]
    finally:
        del sys.modules["gansynth_tpu.fake"]
