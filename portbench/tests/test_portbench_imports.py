"""No module of the benchmark imports JAX or the JAX package, compared by the
whole top-level name (the port's name begins with the JAX package's); the
reference imports nothing of the program either."""

import ast

import pytest

from conftest import BENCH

FORBIDDEN = {"jax", "jaxlib", "flax", "semantic_depth_tpu"}
MODULES = sorted(BENCH.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


def test_the_walk_sees_every_module():
    assert len(MODULES) >= 20
    assert {"run.py", "readings.py"} <= {p.name for p in MODULES}


@pytest.mark.parametrize("path", MODULES, ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "semantic_depth_tpu_torch" not in names and "portbench" not in names


def test_top_level_names_compare_whole():
    from portbench.run import FORBIDDEN as RUN_FORBIDDEN

    assert set(RUN_FORBIDDEN) == FORBIDDEN
    assert "semantic_depth_tpu_torch".split(".")[0] not in FORBIDDEN
