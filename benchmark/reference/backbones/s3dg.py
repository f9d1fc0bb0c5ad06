"""Plain float32 S3D-G (Xie et al. 2018, "Rethinking Spatiotemporal
Feature Learning"): separable (1,k,k) + (k,1,1) convolutions with
self-gating, Inception blocks of the Inception-v1 widths, batch norm with
eps 1e-3. Parameter names are the port's
(``encoder.feature.sepConv1.sep_conv.0.conv3d.weight``), so one state
dict loads into both.
"""
from __future__ import annotations

import torch
from torch import nn

from benchmark.reference.models import BN, Conv, MaxPool, Quant

S3DG_EPS = 1e-3


class BasicConv3d(nn.Module):
    """conv (no bias) -> BN -> ReLU."""

    def __init__(self, cin, cout, k, stride=1, pad=0):
        super().__init__()
        self.conv3d = Conv(cin, cout, k, stride, pad)
        self.bn = BN(cout, S3DG_EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.conv3d(x)))


class SepConv3d(nn.Module):
    """(1,k,k) then (k,1,1) BasicConv3d, then the self-gating: a sigmoid of
    a 1^3 convolution (with bias) of the clip's spatio-temporal mean,
    multiplying every channel."""

    def __init__(self, cin, cout, k, stride=1, pad=0):
        super().__init__()
        self.sep_conv = nn.Sequential(
            BasicConv3d(cin, cout, (1, k, k), stride, (0, pad, pad)),
            BasicConv3d(cout, cout, (k, 1, 1), 1, (pad, 0, 0)))
        self.excitation = Conv(cout, cout, 1, bias=True)
        self.quant: Quant = None

    def forward(self, x):
        q = self.quant or (lambda t: t)
        x = self.sep_conv(x)
        gate = q(torch.sigmoid(self.excitation(q(x.mean(dim=(2, 3, 4),
                                                        keepdim=True)))))
        return q(gate * x)


class Mixed(nn.Module):
    """Inception block: 1^3 | 1^3 -> sep 3 | 1^3 -> sep 3 | pool -> 1^3."""

    def __init__(self, cin, oc):
        super().__init__()
        self.branch0 = BasicConv3d(cin, oc[0], 1)
        self.branch1 = nn.Sequential(BasicConv3d(cin, oc[1], 1),
                                     SepConv3d(oc[1], oc[2], 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv3d(cin, oc[3], 1),
                                     SepConv3d(oc[3], oc[4], 3, 1, 1))
        self.branch3 = nn.Sequential(MaxPool(3, 1, 1),
                                     BasicConv3d(cin, oc[5], 1))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


# Xie et al. 2018, table of the Inception-v1 widths: (name, widths, pool
# before the block as (kernel, stride, padding))
MIXED = [
    ("sepInc_3b", (64, 96, 128, 16, 32, 32), None),
    ("sepInc_3c", (128, 128, 192, 32, 96, 64), None),
    ("sepInc_4b", (192, 96, 208, 16, 48, 64), (3, 2, 1)),
    ("sepInc_4c", (160, 112, 224, 24, 64, 64), None),
    ("sepInc_4d", (128, 128, 256, 24, 64, 64), None),
    ("sepInc_4e", (112, 144, 288, 32, 64, 64), None),
    ("sepInc_4f", (256, 160, 320, 32, 128, 128), None),
    ("sepInc_5b", (256, 160, 320, 32, 128, 128), (2, 2, 0)),
    ("sepInc_5c", (384, 192, 384, 48, 128, 128), None),
]


class S3DG(nn.Module):
    feature_dim = 1024

    def __init__(self):
        super().__init__()
        layers = [("sepConv1", SepConv3d(3, 64, 7, 2, 3)),
                  ("maxPool1", MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1))),
                  ("basicConv3d", BasicConv3d(64, 64, 1)),
                  ("sep_conv2", SepConv3d(64, 192, 3, 1, 1)),
                  ("maxPool2", MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1)))]
        c = 192
        for name, oc, pool in MIXED:
            if pool is not None:
                layers.append((f"maxPool_{name}", MaxPool(*pool)))
            layers.append((name, Mixed(c, oc)))
            c = oc[0] + oc[2] + oc[4] + oc[5]
        self.feature = nn.Sequential()
        for name, mod in layers:
            self.feature.add_module(name, mod)

    def features(self, x):
        return self.feature(x)


def build() -> nn.Module:
    return S3DG()
