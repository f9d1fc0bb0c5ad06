"""The port's torchvision ``r3d_18`` (rspnet_tpu_torch/models/
video_resnet.py, the arch ``torchvision-resnet18``) against the JAX
package's, on the CPU.

- Forward parity in f64 at atol 1e-8 / rtol 1e-7, input [2, 8, 32, 32,
  3]: in train mode the output, every updated BN statistic and every
  parameter's gradient, in eval mode the output and ``features``
  (tests/test_torch_slowfast.py:forward_grad_parity).
- The module names are torchvision's, the torch side of
  rspnet_tpu/models/torch_bridge.py:_torchvision_r3d18_mapping, so a
  torchvision state dict loads through the prefix strip of ``--mc``.
- ``models/convert.py`` both ways as a bare backbone, a pretraining
  wrapper and a finetuning one.
- ``model.pretrain: true`` logs the JAX package's warning and downloads
  nothing; ``config/finetune/ucf101_resnet18.jsonnet -x add.r18k400``
  finetunes it on the CPU at test sizes, as multitask and as ``1stream``
  from a torchvision-named state dict.
"""
import logging

import numpy as np
import pytest
import torch

from rspnet_tpu.models import get_model_class as jax_model_class
from rspnet_tpu.models.torch_bridge import KEY_MAPPERS as BRIDGE_MAPPERS
from rspnet_tpu_torch.models import get_model_class, video_resnet
from tests.test_torch_slowfast import forward_grad_parity
from tests.test_torch_zoo import release_jax_memory  # noqa: F401
from tests.test_torch_zoo import layout_modules, round_trip
from tests.torch_checkpoints import drop_checkpoints  # noqa: F401

torch.set_num_threads(1)
ARCH = "torchvision-resnet18"
T, S, NC = 8, 32, 5


def test_forward_and_gradients_match_jax():
    x = np.random.RandomState(0).randn(2, T, S, S, 3)
    net = forward_grad_parity(
        jax_model_class(ARCH)(num_classes=NC),
        get_model_class(ARCH)(num_classes=NC, with_classifier=True), ARCH, x)
    assert net.feature_dim == 512 and net.fc.out_features == NC


def test_torchvision_names():
    net = get_model_class(ARCH)(with_classifier=True)
    names = {k for k in net.state_dict()
             if not k.endswith("num_batches_tracked")}
    assert names == {k for k, _ in BRIDGE_MAPPERS[ARCH]()}


@pytest.mark.parametrize("layout", ["backbone", "pretrain", "finetune"])
def test_conversion_round_trip(layout):
    round_trip(ARCH, *layout_modules(layout, jax_model_class(ARCH),
                                     get_model_class(ARCH)))


def test_pretrain_flag_warns(caplog):
    with caplog.at_level(logging.WARNING, logger=video_resnet.__name__):
        net = get_model_class(ARCH, pretrain=True)()
    assert isinstance(net, video_resnet.VideoResNet)
    assert "not bundled" in caplog.text
    with pytest.raises(NotImplementedError, match="not ported"):
        get_model_class(ARCH, variant="x")


def test_cli_finetune_r18k400(tmp_path, monkeypatch):
    """The published use: ``-x add.r18k400`` (``pretrain: true``) on
    config/finetune/ucf101_resnet18.jsonnet, multitask; then ``1stream``
    with ``--mc`` from a torchvision-named state dict, which loads
    through the prefix strip into the backbone (its ``fc`` stays)."""
    from rspnet_tpu_torch import finetune
    from tests.conftest import REPO_ROOT
    from tests.test_torch_r2plus1d import FINETUNE_X

    monkeypatch.chdir(REPO_ROOT)
    argv = ["-c", "config/finetune/ucf101_resnet18.jsonnet", "-d", "--seed",
            "0", "--device", "cpu"]
    ft, final = finetune.main(argv + ["-e", str(tmp_path / "mt"), "-x",
                                      "add.r18k400", FINETUNE_X % ""])
    assert isinstance(ft.model.encoder, video_resnet.VideoResNet)
    assert ft.model_type == "multitask" and ft.arch == ARCH
    assert len(ft.step_times) == 2 and np.isfinite(final["loss"])
    # a third-party file in torchvision's names (what r3d_18's
    # state_dict() holds, its fc included)
    src = get_model_class(ARCH)(num_classes=400, with_classifier=True)
    torch.save({"state_dict": {f"module.{k}": v for k, v in
                               src.state_dict().items()}},
               tmp_path / "r3d_18.pth")
    ft1, final1 = finetune.main(argv + [
        "-e", str(tmp_path / "os"), "-x", "add.r18k400",
        FINETUNE_X % ", model_type: '1stream'", "--mc",
        str(tmp_path / "r3d_18.pth")])
    assert isinstance(ft1.model, video_resnet.VideoResNet)
    assert ft1.model.fc.out_features == 4
    assert len(ft1.step_times) == 2 and np.isfinite(final1["loss"])
