"""No module of the benchmark imports JAX or the JAX package, compared by
whole top-level name, and the reference imports nothing of the program."""

import ast
from pathlib import Path

import pytest

PB = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "mfmg_tpu"}
SOURCES = sorted(PB.rglob("*.py"))


def top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") in (
                "import_module", "__import__"):
            for a in node.args[:1]:
                if isinstance(a, ast.Constant) and isinstance(a.value, str):
                    names.add(a.value.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PB)))
def test_no_jax(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted((PB / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_no_program(path):
    found = top_level_imports(path)
    assert "mfmg_torch" not in found
    assert found <= {"__future__", "importlib", "itertools", "math", "numpy",
                     "scipy", "torch", "portbench"}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and \
                node.module.startswith("portbench"):
            assert node.module.startswith("portbench.reference")


def test_top_level_name_is_compared_whole():
    # mfmg_torch begins with the letters of mfmg_t...; it is not the JAX package
    assert "mfmg_torch".split(".")[0] not in BANNED
