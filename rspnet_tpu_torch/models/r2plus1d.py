"""R(2+1)D backbone in torch (port of rspnet_tpu/models/r2plus1d.py).

Each (kt, kh, kw) convolution is factored into a (1, kh, kw) spatial conv,
BN and a ReLU, then a bare (kt, 1, 1) temporal conv; the middle width is
the R(2+1)D paper's formula (``intermediate_channels``). Residual blocks
take their BN and ReLU after each factored conv, and the first block of
stages 3-5 strides 2 with a factored 1^3 projection. No max pool. A 512-d
global average pool and an optional ``linear`` head. BN: eps 1e-5, torch
momentum 0.1. Module names are the reference torch model's
(rspnet_tpu/models/torch_bridge.py:_r2plus1d_mapping): ``conv1.spatial_conv``,
``conv1.bn``, ``conv1.temporal_conv``, ``bn1``, ``conv{2..5}.block1`` and
``conv{2..5}.blocks.{i}``, ``linear``. ``dtype`` is the compute dtype
(models/common.py).

The middle widths at the published sizes are 83 (stem), 144, 230, 288,
460, 576, 921 and 1152, and the projections' 42, 85 and 170: most are no
multiple of 8 (PERF.md §5 records which convolution kernels they get).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from ..framework import tracing
from .common import (BatchNorm, IntOr3, _triple, conv3d, conv_bn, dense,
                     global_avg_pool, make_conv)


def intermediate_channels(kernel_size: Tuple[int, int, int],
                          in_channels: int, out_channels: int) -> int:
    """M of the R(2+1)D paper's §3.5 (rspnet_tpu/models/r2plus1d.py:18)."""
    kt, kh, kw = kernel_size
    return int(math.floor(
        (kt * kh * kw * in_channels * out_channels)
        / (kh * kw * in_channels + kt * out_channels)))


class SpatioTemporalConv(nn.Module):
    """(1, kh, kw) conv -> BN -> ReLU -> bare (kt, 1, 1) conv.

    Each forward counts ``backbone.factored_conv_calls``; while the tracer
    is on, the spatial half (conv, BN, ReLU) is the device span
    ``rsp.backbone.spatial`` and the temporal conv ``rsp.backbone.temporal``
    (framework/tracing.py)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr3, stride: IntOr3 = 1, padding: IntOr3 = 0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        k, s, p = _triple(kernel_size), _triple(stride), _triple(padding)
        mid = intermediate_channels(k, in_channels, out_channels)
        self.spatial_conv = make_conv(in_channels, mid, (1, k[1], k[2]),
                                      (1, s[1], s[2]), (0, p[1], p[2]))
        self.bn = BatchNorm(mid, dtype=dtype)
        self.temporal_conv = make_conv(mid, out_channels, (k[0], 1, 1),
                                       (s[0], 1, 1), (p[0], 0, 0))
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tracing.add("backbone.factored_conv_calls")
        with tracing.device_span("rsp.backbone.spatial"):
            x = conv_bn(self.spatial_conv, self.bn, x, self.dtype)
        with tracing.device_span("rsp.backbone.temporal"):
            return conv3d(self.temporal_conv, x, self.dtype)


class ResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, downsample: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        pad = kernel_size // 2
        stride = 2 if downsample else 1
        self.conv1 = SpatioTemporalConv(in_channels, out_channels,
                                        kernel_size, stride, pad, dtype)
        self.bn1 = BatchNorm(out_channels, dtype=dtype)
        self.conv2 = SpatioTemporalConv(out_channels, out_channels,
                                        kernel_size, 1, pad, dtype)
        self.bn2 = BatchNorm(out_channels, dtype=dtype)
        self.downsample = downsample
        if downsample:
            self.downsampleconv = SpatioTemporalConv(
                in_channels, out_channels, 1, 2, 0, dtype)
            self.downsamplebn = BatchNorm(out_channels, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = torch.relu(self.bn1(self.conv1(x)))
        res = self.bn2(self.conv2(res))
        if self.downsample:
            x = self.downsamplebn(self.downsampleconv(x))
        return torch.relu(x + res)


class ResLayer(nn.Module):
    """One stage: ``block1`` (the projection, from stage 3 on) and
    ``blocks``, the reference's names."""

    def __init__(self, in_channels: int, out_channels: int, n_blocks: int,
                 downsample: bool, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.block1 = ResBlock(in_channels, out_channels, 3, downsample,
                               dtype)
        self.blocks = nn.Sequential(*[
            ResBlock(out_channels, out_channels, 3, False, dtype)
            for _ in range(n_blocks - 1)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.blocks(self.block1(x))


class R2Plus1DNet(nn.Module):
    """Input and output of ``forward`` are NDHWC; ``features`` takes and
    gives NCDHW channels-last views."""

    feature_dim = 512

    def __init__(self, layer_sizes: Sequence[int] = (1, 1, 1, 1),
                 num_classes: int = 101, with_classifier: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.conv1 = SpatioTemporalConv(3, 64, (3, 7, 7), (1, 2, 2),
                                        (1, 3, 3), dtype)
        self.bn1 = BatchNorm(64, dtype=dtype)
        in_ch = 64
        for stage, (width, n) in enumerate(zip((64, 128, 256, 512),
                                               layer_sizes)):
            setattr(self, f"conv{stage + 2}",
                    ResLayer(in_ch, width, n, stage > 0, dtype))
            in_ch = width
        self.linear = (nn.Linear(self.feature_dim, num_classes)
                       if with_classifier else None)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCDHW (channels-last memory) -> the conv5 map [B, 512, t, h, w]."""
        x = torch.relu(self.bn1(self.conv1(x)))
        for stage in (self.conv2, self.conv3, self.conv4, self.conv5):
            x = stage(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = global_avg_pool(self.features(x.permute(0, 4, 1, 2, 3)))
        if self.linear is not None:
            out = dense(out, self.linear, self.dtype)
        return out


def r2plus1d_vcop(**kw) -> R2Plus1DNet:
    return R2Plus1DNet(layer_sizes=(1, 1, 1, 1), **kw)


def r2plus1d_18(**kw) -> R2Plus1DNet:
    return R2Plus1DNet(layer_sizes=(2, 2, 2, 2), **kw)
