"""CPU smoke of the port's pretraining CLI and engine.

``python -m rspnet_tpu_torch.pretrain --device cpu -d`` on a tiny synthetic
S3D-G config, in both geometries; the checkpoint it writes resumes; the
default device (cuda) raises without a card; ``cache_device`` trains from
the device cache and only a value it does not know raises;
``--validate`` runs one statistics epoch and writes no checkpoint.
"""
import subprocess
import sys

import pytest
import torch

from rspnet_tpu_torch import pretrain
from rspnet_tpu_torch.data.device_cache import DeviceCachedLoader
from rspnet_tpu_torch.engines.pretrain import resolve_device
from tests.conftest import REPO_ROOT
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)

TINY = ('{dataset+: {name: "synthetic", num_samples: 8, height: 40, '
        'width: 48}, batch_size: 2, num_workers: 1, '
        'spatial_transforms+: {size: 32}, temporal_transforms+: {_size:: 8}, '
        'moco+: {k: 8}%s}')


def _argv(exp, extra="", *more):
    return ["-c", "config/pretrain/s3dg.jsonnet", "-e", str(exp), "-x",
            TINY % extra, "-d", "--seed", "0", "--device", "cpu", *more]


def test_cli_module_runs_on_cpu(tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "rspnet_tpu_torch.pretrain",
         *_argv(tmp_path, ", device_geometry: true")],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "checkpoint.pth.tar").exists()
    assert (tmp_path / "model_best.pth.tar").exists()


def test_engine_host_geometry_and_resume(tmp_path, monkeypatch):
    monkeypatch.chdir(REPO_ROOT)
    cv2 = pytest.importorskip("cv2")  # host geometry resizes with OpenCV
    del cv2
    engine = pretrain.main(_argv(tmp_path))
    assert len(engine.step_times) == 3
    loss = engine.meters["loss"].avg
    assert torch.isfinite(torch.tensor(loss))
    assert engine.state.queue_ptr == (3 * 2) % 8
    ckpt = tmp_path / "checkpoint.pth.tar"
    resumed = pretrain.main(_argv(tmp_path / "again", "",
                                  "--load-checkpoint", str(ckpt)))
    # resumed from epoch 1 of a 1-epoch debug run: nothing left to train,
    # the loaded queue pointer and encoder weights come back unchanged
    assert resumed.state.queue_ptr == engine.state.queue_ptr
    for a, b in zip(resumed.state.model_q.parameters(),
                    engine.state.model_q.parameters()):
        assert torch.equal(a, b)


def test_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda")


@pytest.mark.parametrize("extra", [", cache_device: true"])
def test_unported_options_raise(tmp_path, monkeypatch, extra):
    """No pretrain option is left unported: ``cache_device``
    (data/device_cache.py) trains from the cache, and a value the cache
    does not know raises."""
    monkeypatch.chdir(REPO_ROOT)
    engine = pretrain.main(_argv(tmp_path, extra + ", device_geometry: true"))
    assert isinstance(engine.train_loader, DeviceCachedLoader)
    assert len(engine.step_times) == 3
    with pytest.raises(ValueError, match="cache_device"):
        pretrain.main(_argv(tmp_path / "bad", ", cache_device: 'val'"))


def test_validate_runs(tmp_path):
    """``--validate`` from a fresh model: one statistics epoch, logged, and
    no checkpoint."""
    proc = subprocess.run(
        [sys.executable, "-m", "rspnet_tpu_torch.pretrain",
         *_argv(tmp_path, ", device_geometry: true", "--validate")],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "Validate statistics: loss" in proc.stdout + proc.stderr
    assert not list(tmp_path.rglob("*.pth.tar"))
