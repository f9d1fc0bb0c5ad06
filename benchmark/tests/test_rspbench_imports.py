"""Nothing the benchmark runs may load JAX or the JAX package, and the
plain reference may not lean on the program it judges.

The AST walk compares the top-level name of each import (the part before
the first dot) whole: ``rspnet_tpu_torch`` is the program under test and
passes; ``rspnet_tpu`` does not."""
from __future__ import annotations

import ast
import sys
import types
from pathlib import Path

import pytest

from benchmark import run

BENCH = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "rspnet_tpu"}


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


FILES = sorted(p for p in BENCH.rglob("*.py")
               if "data" not in p.relative_to(BENCH).parts[:1])


@pytest.mark.parametrize("path", FILES,
                         ids=lambda p: str(p.relative_to(BENCH)))
def test_no_jax_import(path):
    found = set(_top_level_imports(path)) & BANNED
    assert not found, f"{path} imports {sorted(found)}"


@pytest.mark.parametrize(
    "path", sorted((BENCH / "reference").rglob("*.py")),
    ids=lambda p: str(p.relative_to(BENCH)))
def test_reference_imports_nothing_of_the_program(path):
    names = set(_top_level_imports(path))
    assert not names & (BANNED | {"rspnet_tpu_torch"}), path


def test_run_guard_names_whole_top_level_modules(monkeypatch):
    assert run.BANNED == BANNED
    monkeypatch.setitem(sys.modules, "rspnet_tpu_torch_fake.sub",
                        types.ModuleType("x"))
    assert run.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert run.banned_modules() == ["jaxlib"]
