"""The port reads the pyslowfast YAMLs without PyYAML
(rspnet_tpu_torch/config/yaml_subset.py), on the CPU.

- Every file under config/slowfast-configs/ (37: Kinetics, Kinetics/c2,
  AVA, AVA/c2) reads to exactly what ``yaml.safe_load`` gives, types
  included, and ``spec_from_yaml`` gives the JAX package's spec on each.
- Plain scalars resolve as PyYAML's YAML 1.1 resolver: booleans, null,
  ints (decimal, hex, octal, binary, underscores), floats only with a
  dot (``1e-4`` stays a string, as in ``safe_load``), quoted strings; a
  flow list over several lines with a trailing comma; what the reader
  does not build (a flow mapping, an escape, ...) raises.
"""
import dataclasses
import glob
import math
import os

import pytest
import yaml

from rspnet_tpu.models import slowfast as jsf
from rspnet_tpu_torch.config import yaml_subset
from rspnet_tpu_torch.models import slowfast as sf
from tests.conftest import REPO_ROOT

PATHS = sorted(glob.glob(os.path.join(
    REPO_ROOT, "config/slowfast-configs/**/*.yaml"), recursive=True))


def _same(a, b) -> bool:
    """Equal values of equal types, all the way down."""
    if type(a) is not type(b):
        return False
    if isinstance(a, dict):
        return list(a) == list(b) and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, list):
        return len(a) == len(b) and all(map(_same, a, b))
    if isinstance(a, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def test_every_config_is_read():
    assert len(PATHS) == 37


@pytest.mark.parametrize("path", PATHS,
                         ids=lambda p: os.path.relpath(p, REPO_ROOT))
def test_reader_equals_safe_load_and_spec_equals_jax(path):
    with open(path) as f:
        want = yaml.safe_load(f)
    got = yaml_subset.load(path)
    assert _same(got, want)
    assert dataclasses.asdict(sf.spec_from_yaml(path)) == dataclasses.asdict(
        jsf.spec_from_yaml(path))


SCALARS = ["1e-4", "1e-7", "0.000125", "5.0", "1.0e+5", "1.0e5", "-3",
           "+4", "0", "017", "0x1F", "0b101", "1_000", ".5", "-.inf",
           ".NaN", "~", "null", "", "True", "off", "Yes", "NO", "abc",
           ".", "steps_with_relative_lrs", "a b", "'quoted # not a comment'",
           '"dq"', "0.1 # a comment", "[1, [2, [3, []]], 'x', 4.5]"]


@pytest.mark.parametrize("text", SCALARS)
def test_scalars_resolve_as_safe_load(text):
    doc = f"K: {text}\n"
    assert _same(yaml_subset.loads(doc), yaml.safe_load(doc))


def test_nested_blocks_and_multiline_flow():
    doc = ("A:\n  B:\n    C: 1\n  D: [\n    \"x\",\n    \"y\",\n  ]\n"
           "# comment\nE:\nF: [[[], []], [[1, 3], []]]\n")
    assert _same(yaml_subset.loads(doc), yaml.safe_load(doc))


@pytest.mark.parametrize("doc", ["A:\n  - 1\n", "A: &x 1\n", "A: !!int 1\n",
                                 "A: |\n  text\n", "A: 1:30\n",
                                 "A: 2002-12-14\n", "A: [1, 2\n",
                                 "A: {B: 1}\n", 'A: ["a\\tb"]\n'])
def test_unsupported_yaml_raises(doc):
    with pytest.raises(ValueError):
        yaml_subset.loads(doc)
