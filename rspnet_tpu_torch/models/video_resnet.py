"""torchvision's VideoResNet ``r3d_18`` in torch (port of
rspnet_tpu/models/video_resnet.py; the arch ``torchvision-resnet18``).

A (3,7,7) stem with stride (1,2,2) and no max pool, then four stages of
two ``BasicBlock``s (3^3 convolutions) whose first block strides 2 in T,
H and W from the second stage on, a global average pool and an optional
``fc``. Module names are torchvision's (rspnet_tpu/models/torch_bridge.py:
_torchvision_r3d18_mapping): ``stem.{0,1}``, ``layer{L}.{i}.conv{1,2}.
{0,1}``, ``layer{L}.0.downsample.{0,1}``, ``fc``, so a torchvision
``r3d_18`` state dict loads through ``engines/transfer.py``'s prefix strip.
``dtype`` is the compute dtype (models/common.py).
"""
from __future__ import annotations

import logging
from typing import Optional, Sequence

import torch
from torch import nn

from .common import BatchNorm, conv_bn, dense, global_avg_pool, make_conv

logger = logging.getLogger(__name__)


def _conv_bn_seq(in_planes: int, planes: int, kernel, stride, padding,
                 dtype: Optional[torch.dtype]) -> nn.Sequential:
    return nn.Sequential(make_conv(in_planes, planes, kernel, stride,
                                   padding),
                         BatchNorm(planes, dtype=dtype))


class VideoBasicBlock(nn.Module):
    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _conv_bn_seq(in_planes, planes, 3, stride, 1, dtype)
        self.conv2 = _conv_bn_seq(planes, planes, 3, 1, 1, dtype)
        self.downsample = (
            _conv_bn_seq(in_planes, planes, 1, stride, 0, dtype)
            if stride != 1 or in_planes != planes else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_bn(*self.conv1, x, self.dtype)
        out = conv_bn(*self.conv2, out, self.dtype, activation=False)
        res = (x if self.downsample is None else
               conv_bn(*self.downsample, x, self.dtype, activation=False))
        return torch.relu(out + res)


class VideoResNet(nn.Module):
    """Input and output of ``forward`` are NDHWC; ``features`` takes and
    gives NCDHW channels-last views."""
    feature_dim = 512

    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 400, with_classifier: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.stem = _conv_bn_seq(3, 64, (3, 7, 7), (1, 2, 2), (1, 3, 3),
                                 dtype)
        in_planes = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                layers)):
            blocks = []
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(VideoBasicBlock(in_planes, planes, stride,
                                              dtype))
                in_planes = planes
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = (nn.Linear(self.feature_dim, num_classes)
                   if with_classifier else None)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCDHW (channels-last memory) -> [B, 512, t, h, w]."""
        x = conv_bn(*self.stem, x, self.dtype)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = global_avg_pool(self.features(x.permute(0, 4, 1, 2, 3)))
        if self.fc is not None:
            out = dense(out, self.fc, self.dtype)
        return out


def r3d_18(pretrain: bool = False, **kw) -> VideoResNet:
    """``model.pretrain: true`` (the ``r18k400`` finetune mixin) logs what
    the JAX package logs (video_resnet.py:82-91) and downloads nothing."""
    if pretrain:
        logger.warning(
            "torchvision-resnet18 pretrained weights are not bundled (no "
            "download path); the module names are torchvision's, so pass "
            "a torchvision r3d_18 state dict (or a converted checkpoint) "
            "with --mc")
    return VideoResNet(layers=(2, 2, 2, 2), **kw)
