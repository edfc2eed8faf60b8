"""Nothing under benchmark/ imports JAX or the JAX package, compared by
whole top-level names, and the reference imports nothing of the
program."""

import ast
import os

import pytest

from conftest import ROOT

BENCH = os.path.join(ROOT, "benchmark")
FORBIDDEN = {"jax", "jaxlib", "flax", "bm25_tpu"}


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def python_files():
    for dirpath, dirnames, files in os.walk(BENCH):
        dirnames[:] = [d for d in dirnames if d != ".cache"]
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


@pytest.mark.parametrize("path", sorted(python_files()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_whole_names_not_prefixes():
    names = set(top_level_imports(os.path.join(BENCH, "harness.py")))
    assert "bm25_tpu_torch" in names and "bm25_tpu" not in names


def test_reference_and_check_import_nothing_of_the_program():
    for f in ("reference.py", "check.py", "gen.py"):
        names = set(top_level_imports(os.path.join(BENCH, f)))
        assert names <= {"__future__", "math", "numpy", "torch"}, (f, names)


def test_run_refuses_a_process_with_jax_loaded(monkeypatch):
    import sys
    import types

    from benchmark import run

    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax")
    monkeypatch.setitem(sys.modules, "bm25_tpu_torch_x",
                        types.ModuleType("bm25_tpu_torch_x"))
    assert run.forbidden_modules() == []
