"""3-D ResNet backbone in torch (port of rspnet_tpu/models/resnet3d.py).

A 7^3 stem with stride (1,2,2), a 3^3 max pool with stride 2 and padding 1
(through K1/K2), four stages of ``BasicBlock`` (expansion 1) or
``Bottleneck`` (expansion 4) blocks whose first block strides 2 from the
second stage on, shortcut type A (a strided average pool with zero channel
padding) or B (a 1^3 conv and BN), a global average pool and an optional
``fc`` head. BN: eps 1e-5, torch momentum 0.1. Module names are the
reference torch model's (rspnet_tpu/models/torch_bridge.py:
_resnet_mapping): ``conv1``, ``bn1``, ``layer{s}.{i}.conv{c}``,
``layer{s}.{i}.bn{c}``, ``layer{s}.{i}.downsample.{0,1}``, ``fc``.
``dtype`` is the compute dtype (models/common.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .common import (BatchNorm, avg_pool3d, conv_bn, dense, global_avg_pool,
                     make_conv, max_pool3d)


class _Block(nn.Module):
    """What both block kinds share: the shortcut (rspnet_tpu/models/
    resnet3d.py:_shortcut); ``expansion`` is the subclass's."""

    def __init__(self, in_planes: int, planes: int, stride: int,
                 shortcut: str, dtype: Optional[torch.dtype]):
        super().__init__()
        self.out_planes = planes * self.expansion
        self.stride = stride
        self.identity = stride == 1 and in_planes == self.out_planes
        self.shortcut = shortcut
        self.dtype = dtype
        if not self.identity and shortcut == "B":
            self.downsample = nn.Sequential(
                make_conv(in_planes, self.out_planes, 1, stride),
                BatchNorm(self.out_planes, dtype=dtype))
        else:
            self.downsample = None

    def residual(self, x: torch.Tensor) -> torch.Tensor:
        if self.identity:
            return x
        if self.shortcut == "A":
            out = avg_pool3d(x, 1, self.stride)
            return F.pad(out, (0, 0, 0, 0, 0, 0,
                               0, self.out_planes - out.shape[1]))
        return conv_bn(self.downsample[0], self.downsample[1], x, self.dtype,
                       activation=False)


class BasicBlock(_Block):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 shortcut: str = "B", dtype: Optional[torch.dtype] = None):
        super().__init__(in_planes, planes, stride, shortcut, dtype)
        self.conv1 = make_conv(in_planes, planes, 3, stride, 1)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = make_conv(planes, planes, 3, 1, 1)
        self.bn2 = BatchNorm(planes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_bn(self.conv1, self.bn1, x, self.dtype)
        out = conv_bn(self.conv2, self.bn2, out, self.dtype, activation=False)
        return torch.relu(out + self.residual(x))


class Bottleneck(_Block):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 shortcut: str = "B", dtype: Optional[torch.dtype] = None):
        super().__init__(in_planes, planes, stride, shortcut, dtype)
        self.conv1 = make_conv(in_planes, planes, 1)
        self.bn1 = BatchNorm(planes, dtype=dtype)
        self.conv2 = make_conv(planes, planes, 3, stride, 1)
        self.bn2 = BatchNorm(planes, dtype=dtype)
        self.conv3 = make_conv(planes, self.out_planes, 1)
        self.bn3 = BatchNorm(self.out_planes, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_bn(self.conv1, self.bn1, x, self.dtype)
        out = conv_bn(self.conv2, self.bn2, out, self.dtype)
        out = conv_bn(self.conv3, self.bn3, out, self.dtype, activation=False)
        return torch.relu(out + self.residual(x))


class ResNet3D(nn.Module):
    """Input and output of ``forward`` are NDHWC; ``features`` takes and
    gives NCDHW channels-last views."""

    def __init__(self, block=BasicBlock, layers: Sequence[int] = (2, 2, 2, 2),
                 num_classes: int = 400, shortcut_type: str = "B",
                 with_classifier: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.feature_dim = 512 * block.expansion
        self.conv1 = make_conv(3, 64, 7, (1, 2, 2), 3)
        self.bn1 = BatchNorm(64, dtype=dtype)
        in_planes = 64
        for stage, (planes, n_blocks) in enumerate(zip((64, 128, 256, 512),
                                                       layers)):
            blocks = []
            for i in range(n_blocks):
                stride = 2 if (stage > 0 and i == 0) else 1
                blocks.append(block(in_planes, planes, stride, shortcut_type,
                                    dtype))
                in_planes = planes * block.expansion
            setattr(self, f"layer{stage + 1}", nn.Sequential(*blocks))
        self.fc = (nn.Linear(self.feature_dim, num_classes)
                   if with_classifier else None)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCDHW (channels-last memory) -> the conv5 map [B, feature_dim,
        t, h, w]."""
        x = conv_bn(self.conv1, self.bn1, x, self.dtype)
        x = max_pool3d(x, 3, 2, 1)
        for stage in (self.layer1, self.layer2, self.layer3, self.layer4):
            x = stage(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = global_avg_pool(self.features(x.permute(0, 4, 1, 2, 3)))
        if self.fc is not None:
            out = dense(out, self.fc, self.dtype)
        return out


# (block, layers) of each depth (rspnet_tpu/models/resnet3d.py:141-166)
DEPTHS = {
    "resnet10": (BasicBlock, (1, 1, 1, 1)),
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
    "resnet152": (Bottleneck, (3, 8, 36, 3)),
    "resnet200": (Bottleneck, (3, 24, 36, 3)),
}

