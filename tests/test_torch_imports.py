"""The port stands alone: no file of rspnet_tpu_torch/ or chip_smoke.py
imports JAX, flax, optax or the rspnet_tpu package (it keeps its own copy of
what it needs). Checked on the AST, so a lazy import inside a function is
caught too."""
import ast
import pathlib

import pytest

from tests.conftest import REPO_ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "rspnet_tpu"}
ROOT = pathlib.Path(REPO_ROOT)
FILES = sorted((ROOT / "rspnet_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield (node.module or "").split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "id", None) == "__import__"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_has_files():
    assert len(FILES) > 20


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_rspnet_tpu_imports(path):
    bad = sorted(set(_imported_roots(path)) & FORBIDDEN)
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_checker_catches_a_forbidden_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("def f():\n    from rspnet_tpu.ops import color\n"
                     "    import jax.numpy as jnp\n")
    assert set(_imported_roots(probe)) == {"rspnet_tpu", "jax"}
