"""MFNet-3D, the multi-fiber network, in torch (port of
rspnet_tpu/models/mfnet.py).

Pre-activation ``BnAcConv`` units (BN, ReLU, then the conv); multi-fiber
units whose 3x3 convolutions are grouped 16 ways; a (3,5,5)/(1,2,2) stem
conv, BN, ReLU and a (1,3,3)/(1,2,2)/(0,1,1) max pool (through K1/K2);
four stages of 3/4/6/3 units (the first unit of stage 2 strides (2,1,1),
of stages 3-5 (1,2,2)); a tail BN and ReLU; ``feature_dim`` 768. Every
conv and the ``fc`` start from Xavier uniform, as the reference
(mfnet.py:19). Module names are the reference's (rspnet_tpu/models/
torch_bridge.py:_mfnet_mapping): ``conv1.{conv,bn}``, ``conv{s}.B{i:02d}.
{conv_i1,conv_i2,conv_m1,conv_m2,conv_w1}.{bn,conv}``, ``tail.bn``, ``fc``.
``dtype`` is the compute dtype (models/common.py).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import torch
from torch import nn

from .common import (BatchNorm, IntOr3, conv3d, dense, global_avg_pool,
                     max_pool3d)

K_SEC = (3, 4, 6, 3)     # units per stage (reference mfnet_3d.py:72-75)


def _xavier_conv(in_channels: int, out_channels: int, kernel: IntOr3,
                 stride: IntOr3 = 1, padding: IntOr3 = 0,
                 groups: int = 1) -> nn.Conv3d:
    conv = nn.Conv3d(in_channels, out_channels, kernel, stride, padding,
                     groups=groups, bias=False)
    nn.init.xavier_uniform_(conv.weight)
    return conv


class BnAcConv(nn.Module):
    """BN -> ReLU -> Conv3d (rspnet_tpu/models/mfnet.py:22)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel: IntOr3 = 1, padding: IntOr3 = 0, stride: IntOr3 = 1,
                 groups: int = 1, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.bn = BatchNorm(in_channels, dtype=dtype)
        self.conv = _xavier_conv(in_channels, out_channels, kernel, stride,
                                 padding, groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv3d(self.conv, torch.relu(self.bn(x)), self.dtype)


class MFUnit(nn.Module):
    """Multi-fiber unit (rspnet_tpu/models/mfnet.py:46): a 1^3 fiber
    mixer (``conv_i1``, ``conv_i2``) added to the input, the grouped 3^3
    (``conv_m1``) and then a 1^3 (first unit) or grouped (1,3,3)
    (``conv_m2``); the first unit projects its shortcut (``conv_w1``)."""

    def __init__(self, num_in: int, num_mid: int, num_out: int,
                 groups: int = 16, stride=(1, 1, 1), first_block: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        num_ix = num_mid // 4
        kw = dict(dtype=dtype)
        self.conv_i1 = BnAcConv(num_in, num_ix, **kw)
        self.conv_i2 = BnAcConv(num_ix, num_in, **kw)
        self.conv_m1 = BnAcConv(num_in, num_mid, (3, 3, 3), (1, 1, 1), stride,
                                groups, **kw)
        if first_block:
            self.conv_m2 = BnAcConv(num_mid, num_out, **kw)
            self.conv_w1 = BnAcConv(num_in, num_out, stride=stride, **kw)
        else:
            self.conv_m2 = BnAcConv(num_mid, num_out, (1, 3, 3), (0, 1, 1),
                                    groups=groups, **kw)
            self.conv_w1 = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x_in = x + self.conv_i2(self.conv_i1(x))
        h = self.conv_m2(self.conv_m1(x_in))
        return h + (x if self.conv_w1 is None else self.conv_w1(x))


class _Stem(nn.Module):
    def __init__(self, dtype: Optional[torch.dtype]):
        super().__init__()
        self.conv = _xavier_conv(3, 16, (3, 5, 5), (1, 2, 2), (1, 2, 2))
        self.bn = BatchNorm(16, dtype=dtype)


class _Tail(nn.Module):
    def __init__(self, channels: int, dtype: Optional[torch.dtype]):
        super().__init__()
        self.bn = BatchNorm(channels, dtype=dtype)


class MFNet3D(nn.Module):
    """Input and output of ``forward`` are NDHWC; ``features`` takes and
    gives NCDHW channels-last views."""
    feature_dim = 768

    def __init__(self, num_classes: int = 128, with_classifier: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = _Stem(dtype)
        num_in, num_mid = 16, 96
        for s, n_units in enumerate(K_SEC):
            units = OrderedDict()
            for i in range(n_units):
                stride = ((2, 1, 1) if (s == 0 and i == 0) else
                          (1, 2, 2) if i == 0 else (1, 1, 1))
                units[f"B{i + 1:02d}"] = MFUnit(num_in, num_mid, num_mid,
                                                16, stride, i == 0, dtype)
                num_in = num_mid
            setattr(self, f"conv{s + 2}", nn.Sequential(units))
            num_mid *= 2
        self.tail = _Tail(num_in, dtype)
        self.fc = None
        if with_classifier:
            self.fc = nn.Linear(self.feature_dim, num_classes)
            nn.init.xavier_uniform_(self.fc.weight)
            nn.init.zeros_(self.fc.bias)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCDHW (channels-last memory) -> [B, 768, t, h, w]."""
        x = torch.relu(self.conv1.bn(conv3d(self.conv1.conv, x, self.dtype)))
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for s in range(len(K_SEC)):
            x = getattr(self, f"conv{s + 2}")(x)
        return torch.relu(self.tail.bn(x))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = global_avg_pool(self.features(x.permute(0, 4, 1, 2, 3)))
        if self.fc is not None:
            out = dense(out, self.fc, self.dtype)
        return out
