"""Plain float32 R(2+1)D-10 (Tran et al. 2018, "A Closer Look at
Spatiotemporal Convolutions for Action Recognition", arXiv:1711.11248), in
the variant that VCOP (Xu et al. 2019, "Self-supervised Spatiotemporal
Learning via Video Clip Order Prediction") pretrains and RSPNet takes over
as the arch ``r2plus1d-vcop``: one residual block a stage.

Each (kt, kh, kw) convolution of a 3-D ResNet is factored (the paper's
§3.5) into a (1, kh, kw) spatial convolution to M channels, batch norm and
a ReLU, then a bare (kt, 1, 1) temporal convolution, with

    M = floor(kt kh kw Cin Cout / (kh kw Cin + kt Cout)),

so that the pair holds as many weights as the convolution it replaces: 83
in the (3, 7, 7) stem, 144 in stage 2, 230 and 288 in stage 3, 460 and 576
in stage 4, 921 and 1152 in stage 5, and 42, 85 and 170 in the factored
1^3 projections of stages 3-5. The stem strides (1, 2, 2); the first
block of stages 3-5 strides 2 in time and in space, its spatial half
taking the spatial stride and its temporal half the temporal one, with a
projection shortcut (a factored 1^3 convolution and BN); there is no max
pool. Batch norm with eps 1e-5 after every factored convolution (the
block's own ``bn1``, ``bn2``, ``downsamplebn``; the stem's ``bn1``), a
ReLU after the first, and after the residual sum.

Departures, each that of the VCOP code RSPNet runs and of the program:

- the stem's middle width is the formula's 83 (torchvision's R(2+1)D stem
  takes 45);
- no convolution has a bias: each feeds a batch norm in training mode,
  where a bias cancels;
- the batch norms use the batch's statistics and do not update their
  running ones (no compared number reads them), as every reference
  backbone here.

Parameter names are the program's (``conv1.spatial_conv``, ``conv1.bn``,
``conv1.temporal_conv``, ``bn1``, ``conv{2..5}.block1.conv1 ...``,
``downsampleconv``, ``downsamplebn``), so one state dict loads into both.
``quant`` rounds the inner ReLU's output of a factored convolution and a
block's residual sum, beside the rounding sites of ``Conv`` and ``BN``.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from benchmark.reference.models import BN, Conv, Quant, _t3

EPS = 1e-5
WIDTHS = (64, 128, 256, 512)


def middle_width(k, cin: int, cout: int) -> int:
    kt, kh, kw = k
    return math.floor(kt * kh * kw * cin * cout / (kh * kw * cin + kt * cout))


class SpatioTemporalConv(nn.Module):
    """(1, kh, kw) conv -> BN -> ReLU -> bare (kt, 1, 1) conv."""

    def __init__(self, cin, cout, k, stride=1, pad=0):
        super().__init__()
        k, s, p = _t3(k), _t3(stride), _t3(pad)
        mid = middle_width(k, cin, cout)
        self.spatial_conv = Conv(cin, mid, (1, k[1], k[2]), (1, s[1], s[2]),
                                 (0, p[1], p[2]))
        self.bn = BN(mid, EPS)
        self.temporal_conv = Conv(mid, cout, (k[0], 1, 1), (s[0], 1, 1),
                                  (p[0], 0, 0))
        self.quant: Quant = None

    def forward(self, x):
        x = torch.relu(self.bn(self.spatial_conv(x)))
        if self.quant is not None:
            x = self.quant(x)
        return self.temporal_conv(x)


class ResBlock(nn.Module):
    def __init__(self, cin, cout, downsample):
        super().__init__()
        stride = 2 if downsample else 1
        self.conv1 = SpatioTemporalConv(cin, cout, 3, stride, 1)
        self.bn1 = BN(cout, EPS)
        self.conv2 = SpatioTemporalConv(cout, cout, 3, 1, 1)
        self.bn2 = BN(cout, EPS)
        self.downsample = downsample
        if downsample:
            self.downsampleconv = SpatioTemporalConv(cin, cout, 1, 2, 0)
            self.downsamplebn = BN(cout, EPS)
        self.quant: Quant = None

    def forward(self, x):
        res = torch.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        if self.downsample:
            x = self.downsamplebn(self.downsampleconv(x))
        out = x + res
        return torch.relu(out if self.quant is None else self.quant(out))


class ResLayer(nn.Module):
    """A stage of one block, named ``block1`` as the program names it."""

    def __init__(self, cin, cout, downsample):
        super().__init__()
        self.block1 = ResBlock(cin, cout, downsample)

    def forward(self, x):
        return self.block1(x)


class R2Plus1D(nn.Module):
    def __init__(self):
        super().__init__()
        self.feature_dim = WIDTHS[-1]
        self.conv1 = SpatioTemporalConv(3, 64, (3, 7, 7), (1, 2, 2),
                                        (1, 3, 3))
        self.bn1 = BN(64, EPS)
        cin = 64
        for i, width in enumerate(WIDTHS):
            setattr(self, f"conv{i + 2}", ResLayer(cin, width, i > 0))
            cin = width

    def features(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        for i in range(2, 6):
            x = getattr(self, f"conv{i}")(x)
        return x


def build() -> nn.Module:
    return R2Plus1D()
