"""Plain float32 3-D ResNet-18 (Hara et al. 2018, "Can Spatiotemporal 3D
CNNs Retrace the History of 2D CNNs and ImageNet?"): a 7^3 stem of stride
(1, 2, 2), a 3^3 max-pool of stride 2, four stages of two basic blocks
with type-B (1^3 convolution + BN) shortcuts, batch norm with eps 1e-5.
Parameter names are the port's (``encoder.layer1.0.conv1.weight``), so
one state dict loads into both.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from benchmark.reference.models import BN, Conv, Quant

RESNET_EPS = 1e-5


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, 1)
        self.bn1 = BN(planes, RESNET_EPS)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.bn2 = BN(planes, RESNET_EPS)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(Conv(cin, planes, 1, stride),
                                            BN(planes, RESNET_EPS))
        self.quant: Quant = None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        short = x if self.downsample is None else self.downsample(x)
        out = out + short
        return torch.relu(out if self.quant is None else self.quant(out))


class ResNet3D(nn.Module):
    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.feature_dim = 512
        self.conv1 = Conv(3, 64, 7, (1, 2, 2), 3)
        self.bn1 = BN(64, RESNET_EPS)
        cin = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(cin, planes,
                                         2 if i > 0 and j == 0 else 1))
                cin = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def features(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool3d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


def build() -> nn.Module:
    return ResNet3D((2, 2, 2, 2))
