"""No module of the benchmark imports JAX or the JAX package, compared by
the whole top-level name (``spfresh_tpu_torch`` begins with
``spfresh_tpu``), and the reference imports nothing of the system."""

import ast
from pathlib import Path

import pytest

from annbench.run import FORBIDDEN, forbidden_modules

HOME = Path(__file__).resolve().parents[1]
SOURCES = sorted(HOME.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HOME)))
def test_no_jax(path):
    assert not top_level_imports(path) & set(FORBIDDEN)


@pytest.mark.parametrize("path", sorted((HOME / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_is_independent_of_the_system(path):
    assert not top_level_imports(path) & {"spfresh_tpu_torch", "annbench"}


def test_top_level_names_compare_whole():
    assert forbidden_modules(["spfresh_tpu_torch", "spfresh_tpu_torch.index", "torch"]) == []
    assert forbidden_modules(["spfresh_tpu.ops", "jax.numpy", "jaxlib", "flax.linen"]) == [
        "flax", "jax", "jaxlib", "spfresh_tpu"]
