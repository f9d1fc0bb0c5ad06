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
    to the rounded convolution."""
    dt = dtype or x.dtype
    y = F.conv3d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                 conv.padding)
    if conv.bias is not None:
        y = y + conv.bias.to(dt).view(-1, 1, 1, 1)
    return y


class ConvBN(nn.Module):
    """Conv3d (no bias) + BatchNorm + ReLU, named like the reference's
    BasicConv3d (``conv3d``, ``bn``) (rspnet_tpu/models/common.py:176)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr3, stride: IntOr3 = 1,
                 padding: IntOr3 = 0, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv3d = nn.Conv3d(in_channels, out_channels,
                                _triple(kernel_size), _triple(stride),
                                _triple(padding), bias=False)
        self.bn = BatchNorm(out_channels, bn_momentum, bn_eps, dtype)
        self.dtype = dtype
        nn.init.kaiming_normal_(self.conv3d.weight, mode="fan_out",
                                nonlinearity="relu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(conv3d(self.conv3d, x, self.dtype)))


def max_pool3d(x: torch.Tensor, kernel, strides, padding=0) -> torch.Tensor:
    """torch MaxPool3d semantics (floor mode, -inf padding) on an NCDHW
    tensor, through kernels K1/K2 (rspnet_tpu/models/common.py:476), in the
    tensor's own dtype (f32 or bf16 on the card)."""
    ndhwc = x.permute(0, 2, 3, 4, 1).contiguous()
    out = _pool.max_pool3d(ndhwc, kernel, strides, padding)
    return out.permute(0, 4, 1, 2, 3)


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
