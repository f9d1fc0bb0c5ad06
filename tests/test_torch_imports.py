"""The port stands alone: no file of rspnet_tpu_torch/ or chip_smoke.py
imports JAX, flax, optax or the rspnet_tpu package (it keeps its own copy of
what it needs). Checked on the AST, so a lazy import inside a function is
caught too.

OpenCV is not on the card machine either: no port file imports ``cv2``
but inside the two functions that decode or resize frames on the host
(``data/video_reader.py``; ``data/pipeline.py:_load_one``, host geometry
only) and the host micro-bench's video writer
(``utils/bench_input_path.py:make_videos``), never at module level. The CAM visualization has its own image
helper (``utils/image.py``).

PyYAML is not on the card machine: no port file imports ``yaml``; the
SlowFast path reads the pyslowfast YAMLs with ``config/yaml_subset.py``,
and building and running a SlowFast from a YAML loads neither ``yaml``
nor ``jax`` (checked in a fresh interpreter)."""
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


# (file, function) pairs that may import cv2 lazily
CV2_ALLOWED = {("rspnet_tpu_torch/data/video_reader.py", "_maybe_resize"),
               ("rspnet_tpu_torch/data/video_reader.py", "__init__"),
               ("rspnet_tpu_torch/data/pipeline.py", "_load_one"),
               ("rspnet_tpu_torch/utils/bench_input_path.py",
                "make_videos")}


def _cv2_imports(path: pathlib.Path):
    """(enclosing function or None, line) of every cv2 import."""
    found = []

    def visit(node, func):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            func = node.name
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        if any(n.split(".")[0] == "cv2" for n in names):
            found.append((func, node.lineno))
        for child in ast.iter_child_nodes(node):
            visit(child, func)
    visit(ast.parse(path.read_text(), filename=str(path)), None)
    return found


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


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_cv2_outside_the_host_decode_path(path):
    rel = str(path.relative_to(ROOT))
    bad = [(func, line) for func, line in _cv2_imports(path)
           if (rel, func) not in CV2_ALLOWED]
    assert not bad, f"{rel} imports cv2 at {bad}"


def test_cv2_checker_catches_a_module_level_import(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import cv2\ndef f():\n    from cv2 import resize\n")
    assert _cv2_imports(probe) == [(None, 1), ("f", 3)]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_yaml_imports(path):
    assert "yaml" not in set(_imported_roots(path)), path.relative_to(ROOT)


def test_slowfast_path_imports_neither_yaml_nor_jax():
    import subprocess
    import sys
    code = (
        "import sys, torch\n"
        "from rspnet_tpu_torch.models import get_model_class\n"
        "from rspnet_tpu_torch.moco import MultiTaskWrapper\n"
        "torch.set_num_threads(1)\n"
        "f = get_model_class('slowfast', cfg_file='config/slowfast-configs/"
        "Kinetics/SLOWFAST_NLN_4x16_R50.yaml')\n"
        "m = MultiTaskWrapper(f(), 8)\n"
        "with torch.no_grad():\n"
        "    a, b = m(torch.randn(2, 16, 32, 32, 3))\n"
        "assert a.shape == (2, 8)\n"
        "print(sorted({n.split('.')[0] for n in sys.modules}"
        " & {'yaml', 'jax', 'jaxlib', 'flax', 'rspnet_tpu'}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
