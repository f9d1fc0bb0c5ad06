"""S3D-G backbone in torch (port of rspnet_tpu/models/s3dg.py).

Separable (1,k,k) -> (k,1,1) convolutions with self-gating, nine inception
blocks, 13 max-pool sites. Module names follow the reference torch model
(rspnet_tpu/models/torch_bridge.py:_s3dg_mapping), e.g.
``feature.sepConv1.sep_conv.0.conv3d``. BN: eps 1e-3, torch momentum 0.001.
Input and output of ``forward`` are NDHWC; inside, NCDHW channels-last views.
``dtype`` is the compute dtype (models/common.py); the self-gating runs in
it too.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional, Sequence

import torch
from torch import nn

from .common import ConvBN, MaxPool3d, conv3d, global_avg_pool

_BN = dict(bn_eps=1e-3, bn_momentum=0.999)


class SepConv(nn.Module):
    """(1,k,k) conv+BN+ReLU, (k,1,1) conv+BN+ReLU, optional self-gating."""

    def __init__(self, in_channels: int, features: int, kernel_size: int,
                 stride: int = 1, padding: int = 0, gate: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        k, p = kernel_size, padding
        self.sep_conv = nn.Sequential(
            ConvBN(in_channels, features, (1, k, k), stride, (0, p, p), **_BN,
                   dtype=dtype),
            ConvBN(features, features, (k, 1, 1), 1, (p, 0, 0), **_BN,
                   dtype=dtype))
        self.gate = gate
        self.dtype = dtype
        if gate:
            self.excitation = nn.Conv3d(features, features, 1, bias=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.sep_conv(x)
        if self.gate:
            weight = x.mean(dim=(2, 3, 4), keepdim=True)
            x = torch.sigmoid(conv3d(self.excitation, weight, self.dtype)) * x
        return x


class SepInc(nn.Module):
    """Inception block: 1x1 | 1x1->sep3 | 1x1->sep3 | pool->1x1."""

    def __init__(self, in_channels: int, oc: Sequence[int], gate: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        bn = dict(_BN, dtype=dtype)
        self.branch0 = ConvBN(in_channels, oc[0], 1, **bn)
        self.branch1 = nn.Sequential(
            ConvBN(in_channels, oc[1], 1, **bn),
            SepConv(oc[1], oc[2], 3, 1, 1, gate, dtype))
        self.branch2 = nn.Sequential(
            ConvBN(in_channels, oc[3], 1, **bn),
            SepConv(oc[3], oc[4], 3, 1, 1, gate, dtype))
        self.branch3 = nn.Sequential(MaxPool3d(3, 1, 1),
                                     ConvBN(in_channels, oc[5], 1, **bn))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], dim=1)


# (torch name, [b0, b1_red, b1, b2_red, b2, b3], pool before the block)
INC_CHANNELS = [
    ("sepInc_3b", [64, 96, 128, 16, 32, 32], None),
    ("sepInc_3c", [128, 128, 192, 32, 96, 64], None),
    ("sepInc_4b", [192, 96, 208, 16, 48, 64], (3, 2, 1)),
    ("sepInc_4c", [160, 112, 224, 24, 64, 64], None),
    ("sepInc_4d", [128, 128, 256, 24, 64, 64], None),
    ("sepInc_4e", [112, 144, 288, 32, 64, 64], None),
    ("sepInc_4f", [256, 160, 320, 32, 128, 128], None),
    ("sepInc_5b", [256, 160, 320, 32, 128, 128], (2, 2, 0)),
    ("sepInc_5c", [384, 192, 384, 48, 128, 128], None),
]


class S3DG(nn.Module):
    """Backbone without the classifier (pretraining builds it that way)."""

    feature_dim = 1024

    def __init__(self, gate: bool = True, dtype: Optional[torch.dtype] = None):
        super().__init__()
        layers = OrderedDict()
        layers["sepConv1"] = SepConv(3, 64, 7, 2, 3, gate, dtype)
        layers["maxPool1"] = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        layers["basicConv3d"] = ConvBN(64, 64, 1, **_BN, dtype=dtype)
        layers["sep_conv2"] = SepConv(64, 192, 3, 1, 1, gate, dtype)
        layers["maxPool2"] = MaxPool3d((1, 3, 3), (1, 2, 2), (0, 1, 1))
        c = 192
        for name, oc, pool in INC_CHANNELS:
            if pool is not None:
                layers[f"maxPool_{name}"] = MaxPool3d(*pool)
            layers[name] = SepInc(c, oc, gate, dtype)
            c = oc[0] + oc[2] + oc[4] + oc[5]
        self.feature = nn.Sequential(layers)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCDHW (channels-last memory) -> feature map [B, 1024, t, h, w]."""
        return self.feature(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NDHWC clip [B, T, H, W, 3] -> pooled features [B, 1024]."""
        return global_avg_pool(self.features(x.permute(0, 4, 1, 2, 3)))


def s3dg(dtype: Optional[torch.dtype] = None) -> S3DG:
    return S3DG(gate=True, dtype=dtype)


def s3d(dtype: Optional[torch.dtype] = None) -> S3DG:
    return S3DG(gate=False, dtype=dtype)

