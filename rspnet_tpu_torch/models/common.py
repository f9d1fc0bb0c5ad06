"""Shared building blocks for the port's backbones (torch, NCDHW views).

Port of rspnet_tpu/models/common.py. Activations are NCDHW tensors in
``torch.channels_last_3d`` memory, which is NDHWC physically, so the pool
kernel's NDHWC view is a free ``permute``.

Compute dtype, as flax's ``dtype`` attribute: ``None`` computes in the
input's dtype; ``torch.bfloat16`` keeps the parameters and BN statistics in
f32 and casts each conv's input and weight to bf16, as the JAX package does
on its accelerator.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import max_pool3d as _pool

IntOr3 = Union[int, Tuple[int, int, int]]


def _triple(x: IntOr3) -> Tuple[int, int, int]:
    if isinstance(x, int):
        return (x, x, x)
    return tuple(x)


class BatchNorm(nn.BatchNorm3d):
    """torch BatchNorm3d with the JAX package's hyper-parameters.

    rspnet_tpu/models/common.py:BatchNorm (:36) normalizes with the biased
    batch variance and updates ``running_var`` with the unbiased one, which
    is what BatchNorm3d does. Its flax momentum m becomes torch 1 - m.
    The statistics are taken in (at least) f32 whatever the input's dtype,
    and the output is cast to ``dtype`` (or stays in the input's), as there
    (:79-80, :106).
    """

    def __init__(self, num_features: int, flax_momentum: float = 0.9,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=eps, momentum=1.0 - flax_momentum)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x).to(self.dtype or x.dtype)


def conv3d(conv: nn.Conv3d, x: torch.Tensor,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv`` as flax's ``nn.Conv(dtype=...)`` computes it: input, weight
    and bias cast to ``dtype`` (the input's dtype if None), the bias added
    to the rounded convolution. The output keeps a channels-last input's
    memory format (cuDNN keeps it; the CPU's one-thread 1^3 convolution
    returns NCDHW, which would put a copy before the next pool)."""
    dt = dtype or x.dtype
    y = F.conv3d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                 conv.padding)
    if x.is_contiguous(memory_format=torch.channels_last_3d):
        y = y.contiguous(memory_format=torch.channels_last_3d)
    if conv.bias is not None:
        y = y + conv.bias.to(dt).view(-1, 1, 1, 1)
    return y


def dense(x: torch.Tensor, linear: nn.Linear,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, weight and bias cast to
    ``dtype`` (the input's if None), the bias added to the rounded
    product."""
    dt = dtype or x.dtype
    return F.linear(x.to(dt), linear.weight.to(dt)) + linear.bias.to(dt)


def make_conv(in_channels: int, out_channels: int, kernel_size: IntOr3,
              stride: IntOr3 = 1, padding: IntOr3 = 0,
              use_bias: bool = False) -> nn.Conv3d:
    """Conv3d with the JAX package's kernel init (kaiming normal, fan_out,
    rspnet_tpu/models/common.py:195) and flax's zero bias."""
    conv = nn.Conv3d(in_channels, out_channels, _triple(kernel_size),
                     _triple(stride), _triple(padding), bias=use_bias)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
    if use_bias:
        nn.init.zeros_(conv.bias)
    return conv


def conv_bn(conv: nn.Conv3d, bn: "BatchNorm", x: torch.Tensor,
            dtype: Optional[torch.dtype], activation: bool = True
            ) -> torch.Tensor:
    """The JAX package's ``ConvBN`` (rspnet_tpu/models/common.py:176): conv
    (with its bias, if it has one), BN, and a ReLU unless ``activation`` is
    False (a residual block's last conv). The modules are passed in, so a
    backbone can register them under the reference's sibling names
    (``conv1`` and ``bn1``), which a ``ConvBN`` child cannot give."""
    y = bn(conv3d(conv, x, dtype))
    return torch.relu(y) if activation else y


class ConvBN(nn.Module):
    """Conv3d (no bias) + BatchNorm + ReLU, named like the reference's
    BasicConv3d (``conv3d``, ``bn``) (rspnet_tpu/models/common.py:176)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr3, stride: IntOr3 = 1,
                 padding: IntOr3 = 0, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv3d = make_conv(in_channels, out_channels, kernel_size,
                                stride, padding)
        self.bn = BatchNorm(out_channels, bn_momentum, bn_eps, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(self.conv3d, self.bn, x, self.dtype)


class ConvNorm(nn.Module):
    """The JAX package's ``ConvBN`` under its own child names (``conv``,
    ``bn``), for backbones and heads whose module names follow the JAX
    tree: a conv (with a bias if ``use_bias``), an optional BN and a ReLU
    unless ``activation`` is False (rspnet_tpu/models/common.py:176)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr3, stride: IntOr3 = 1,
                 padding: IntOr3 = 0, use_bias: bool = False,
                 use_bn: bool = True, activation: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = make_conv(in_channels, out_channels, kernel_size, stride,
                              padding, use_bias)
        self.bn = BatchNorm(out_channels, dtype=dtype) if use_bn else None
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv3d(self.conv, x, self.dtype)
        if self.bn is not None:
            y = self.bn(y)
        return torch.relu(y) if self.activation else y


def max_pool3d(x: torch.Tensor, kernel, strides, padding=0) -> torch.Tensor:
    """torch MaxPool3d semantics (floor mode, -inf padding) on an NCDHW
    tensor, through kernels K1/K2 (rspnet_tpu/models/common.py:476), in the
    tensor's own dtype (f32 or bf16 on the card)."""
    ndhwc = x.permute(0, 2, 3, 4, 1).contiguous()
    out = _pool.max_pool3d(ndhwc, kernel, strides, padding)
    return out.permute(0, 4, 1, 2, 3)


def avg_pool3d(x: torch.Tensor, kernel, strides, padding=0) -> torch.Tensor:
    """torch AvgPool3d semantics (count_include_pad=True) on an NCDHW
    tensor (rspnet_tpu/models/common.py:531): the window sum over zero
    padding, in the tensor's dtype, divided by the window size. Plain
    torch, which takes bf16 on the CPU too; ResNet's type-A shortcut (k 1)
    is an exact strided subsample."""
    k, s, p = _triple(kernel), _triple(strides), _triple(padding)
    x = F.pad(x, (p[2], p[2], p[1], p[1], p[0], p[0]))
    n = [(d - kk) // ss + 1 for d, kk, ss in zip(x.shape[2:], k, s)]
    acc = None
    for dt in range(k[0]):
        for dh in range(k[1]):
            for dw in range(k[2]):
                v = x[:, :, dt:dt + (n[0] - 1) * s[0] + 1:s[0],
                      dh:dh + (n[1] - 1) * s[1] + 1:s[1],
                      dw:dw + (n[2] - 1) * s[2] + 1:s[2]]
                acc = v if acc is None else acc + v
    return acc / (k[0] * k[1] * k[2])


class MaxPool3d(nn.Module):
    def __init__(self, kernel, strides, padding=0):
        super().__init__()
        self.geom = (_triple(kernel), _triple(strides), _triple(padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool3d(x, *self.geom)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d(1) + flatten: [B, C, T, H, W] -> [B, C]; a bf16
    input is summed in f32 and rounded once, as ``jnp.mean`` does."""
    return x.mean(dim=(2, 3, 4))
