"""The reference finds a backbone by its arch name in a file of its own
(``reference/backbones/<arch>.py``): a new architecture is a new file."""
from __future__ import annotations

import shutil

import pytest

from benchmark.reference import models


def test_the_benchmarked_archs_have_files():
    assert {"s3dg", "resnet18"} <= set(models.available())


def test_a_new_file_is_found_by_its_arch_name(tmp_path, monkeypatch):
    shutil.copy(models.BACKBONE_DIR / "resnet18.py",
                tmp_path / "resnet18-copy.py")
    shutil.copy(models.BACKBONE_DIR / "resnet18.py", tmp_path)
    monkeypatch.setattr(models, "BACKBONE_DIR", tmp_path)
    assert models.available() == ["resnet18", "resnet18-copy"]
    new = models.build("resnet18-copy", 128).state_dict()
    old = models.build("resnet18", 128).state_dict()
    assert list(new) == list(old)
    assert all(new[k].shape == old[k].shape for k in old)


def test_an_unknown_arch_names_the_available_ones(tmp_path, monkeypatch):
    shutil.copy(models.BACKBONE_DIR / "s3dg.py", tmp_path)
    monkeypatch.setattr(models, "BACKBONE_DIR", tmp_path)
    with pytest.raises(ValueError, match=r"'r2plus1d-vcop'.*\['s3dg'\]"):
        models.build("r2plus1d-vcop", 128)


@pytest.mark.parametrize("arch", ["../models", "s3dg.py", ""])
def test_a_name_outside_the_files_is_refused(arch):
    with pytest.raises(ValueError, match="no backbone"):
        models.build(arch, 128)


def test_each_file_is_loaded_once():
    a = models.build("s3dg", 8).encoder
    b = models.build("s3dg", 8).encoder
    assert type(a) is type(b)
