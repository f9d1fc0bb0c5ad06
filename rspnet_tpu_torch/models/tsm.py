"""TSM (Temporal Shift Module) on a 2-D ResNet, in torch (port of
rspnet_tpu/models/tsm.py).

Frames stay in the clip's T axis; the "2-D" convolutions are (1, k, k)
3-D convolutions, and the shift moves 1/fold_div of the channels one step
forward in time and 1/fold_div back, zero-padded, before each residual
branch. A (1,7,7)/(1,2,2) stem, a (1,3,3)/(1,2,2)/(0,1,1) max pool
(through K1/K2), BasicBlock (resnet18/34 bases) or Bottleneck (resnet50)
stages, optional non-local blocks after every other block of stages 2
and 3, and a per-segment ``new_fc`` with average consensus over the
frames.

The reference's TSM cannot be imported, so the module names follow the
JAX tree: ``stem.conv``, ``layer1_0.conv1.conv``, ``layer2_0.downsample.bn``,
``nl2_0.theta``, ``nl2_0.w``, ``nl2_0.bn``, ``new_fc``. Activations are
NCDHW views in ``torch.channels_last_3d`` memory; the shift writes into a
``zeros_like`` of its input, which keeps that format, so no layout copy
comes before a conv or K1. ``dtype`` is the compute dtype (models/common.py).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .common import (BatchNorm, ConvNorm, conv3d, dense, make_conv,
                     max_pool3d, softmax_last)


def temporal_shift(x: torch.Tensor, fold_div: int = 8) -> torch.Tensor:
    """x: NCDHW. Channels [0, C/fold_div) take frame t+1, the next
    C/fold_div take frame t-1, the rest stay; zeros where a frame is
    missing (rspnet_tpu/models/tsm.py:25)."""
    fold = x.shape[1] // fold_div
    out = torch.zeros_like(x)
    out[:, :fold, :-1] = x[:, :fold, 1:]
    out[:, fold:2 * fold, 1:] = x[:, fold:2 * fold, :-1]
    out[:, 2 * fold:] = x[:, 2 * fold:]
    return out


def temporal_shift_grouped(x: torch.Tensor, fold_div: int = 3,
                           groups: int = 2) -> torch.Tensor:
    """The grouped shift (rspnet_tpu/models/tsm.py:45): each of ``groups``
    equal channel slices shifts its first gc/fold_div channels from t+1
    and the next gc/fold_div from t-1."""
    if groups == 1:
        raise ValueError("shift_group is not for groups == 1 "
                         "(reference asserts the same)")
    c = x.shape[1]
    if c % groups:
        raise ValueError(f"{c} % {groups} != 0")
    gc = c // groups
    fold = gc // fold_div
    out = torch.zeros_like(x)
    for base in range(0, c, gc):
        a, b, e = base + fold, base + 2 * fold, base + gc
        out[:, base:a, :-1] = x[:, base:a, 1:]
        out[:, a:b, 1:] = x[:, a:b, :-1]
        out[:, b:e] = x[:, b:e]
    return out


class NonLocalBlock(nn.Module):
    """Embedded-gaussian non-local block with a residual
    (rspnet_tpu/models/tsm.py:72): theta / phi / g 1^3 convs to C/2, phi
    and g max-pooled (1,2,2) (K1/K2), softmax(theta phi^T) g, then ``w``
    and a zero-initialised ``bn`` (or a zero ``w``), so the block starts as
    the identity."""

    def __init__(self, channels: int, inter_channels: Optional[int] = None,
                 sub_sample: bool = True, bn_layer: bool = True,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        ic = inter_channels or max(channels // 2, 1)
        self.inter_channels = ic
        self.sub_sample = sub_sample
        self.dtype = dtype
        self.g = make_conv(channels, ic, 1, use_bias=True)
        self.phi = make_conv(channels, ic, 1, use_bias=True)
        self.theta = make_conv(channels, ic, 1, use_bias=True)
        self.w = make_conv(ic, channels, 1, use_bias=True)
        if bn_layer:
            self.bn = BatchNorm(channels, dtype=dtype)
            nn.init.zeros_(self.bn.weight)
        else:
            self.bn = None
            nn.init.zeros_(self.w.weight)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, T, H, W = x.shape
        ic, dt = self.inter_channels, self.dtype
        g = conv3d(self.g, x, dt)
        phi = conv3d(self.phi, x, dt)
        theta = conv3d(self.theta, x, dt)
        if self.sub_sample:
            g = max_pool3d(g, (1, 2, 2), (1, 2, 2), 0)
            phi = max_pool3d(phi, (1, 2, 2), (1, 2, 2), 0)

        def rows(v):                     # NCDHW -> [B, T*H*W, ic]
            return v.permute(0, 2, 3, 4, 1).reshape(B, -1, ic)

        att = softmax_last(torch.bmm(rows(theta), rows(phi).transpose(1, 2)))
        y = torch.bmm(att, rows(g)).reshape(B, T, H, W, ic)
        w = conv3d(self.w, y.permute(0, 4, 1, 2, 3), dt)
        if self.bn is not None:
            w = self.bn(w)
        return x + w


class _ShiftBlock(nn.Module):
    """What both block kinds share: the shift before the residual branch
    and the projection of the shortcut."""

    def __init__(self, in_planes: int, planes: int, stride: int,
                 fold_div: int, shift_groups: int,
                 dtype: Optional[torch.dtype]):
        super().__init__()
        out = planes * self.expansion
        self.fold_div, self.shift_groups = fold_div, shift_groups
        self.downsample = (
            ConvNorm(in_planes, out, 1, (1, stride, stride), 0,
                     activation=False, dtype=dtype)
            if stride != 1 or in_planes != out else None)

    def shift(self, x: torch.Tensor) -> torch.Tensor:
        if self.shift_groups > 1:
            return temporal_shift_grouped(x, self.fold_div,
                                          self.shift_groups)
        return temporal_shift(x, self.fold_div)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.branch(self.shift(x))
        res = self.downsample(x) if self.downsample is not None else x
        return torch.relu(h + res)


class TsmBasicBlock(_ShiftBlock):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 fold_div: int = 8, shift_groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_planes, planes, stride, fold_div, shift_groups,
                         dtype)
        self.conv1 = ConvNorm(in_planes, planes, (1, 3, 3),
                              (1, stride, stride), (0, 1, 1), dtype=dtype)
        self.conv2 = ConvNorm(planes, planes, (1, 3, 3), 1, (0, 1, 1),
                              activation=False, dtype=dtype)

    def branch(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv2(self.conv1(h))


class TsmBottleneck(_ShiftBlock):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1,
                 fold_div: int = 8, shift_groups: int = 1,
                 dtype: Optional[torch.dtype] = None):
        super().__init__(in_planes, planes, stride, fold_div, shift_groups,
                         dtype)
        self.conv1 = ConvNorm(in_planes, planes, 1, dtype=dtype)
        self.conv2 = ConvNorm(planes, planes, (1, 3, 3), (1, stride, stride),
                              (0, 1, 1), dtype=dtype)
        self.conv3 = ConvNorm(planes, planes * 4, 1, activation=False,
                              dtype=dtype)

    def branch(self, h: torch.Tensor) -> torch.Tensor:
        return self.conv3(self.conv2(self.conv1(h)))


class TSM(nn.Module):
    """Input and output of ``forward`` are NDHWC; ``features`` takes and
    gives NCDHW channels-last views. ``basic`` picks BasicBlock stages
    (resnet18/34 bases), else Bottleneck (resnet50)."""

    def __init__(self, num_classes: int = 174,
                 layers: Sequence[int] = (3, 4, 6, 3), basic: bool = False,
                 num_segments: int = 8, fold_div: int = 8,
                 shift_groups: int = 1, non_local: bool = False,
                 with_classifier: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.dtype = dtype
        self.num_segments = num_segments  # informational: T is the input's
        block_cls = TsmBasicBlock if basic else TsmBottleneck
        self.feature_dim = 512 * block_cls.expansion
        self.stem = ConvNorm(3, 64, (1, 7, 7), (1, 2, 2), (0, 3, 3),
                             dtype=dtype)
        # (block name, non-local block name or None) in forward order
        self.order = []
        in_planes = 64
        for stage, (planes, n) in enumerate(zip((64, 128, 256, 512),
                                                layers)):
            for i in range(n):
                stride = 2 if (stage > 0 and i == 0) else 1
                name = f"layer{stage + 1}_{i}"
                setattr(self, name, block_cls(in_planes, planes, stride,
                                              fold_div, shift_groups, dtype))
                in_planes = planes * block_cls.expansion
                nl = None
                # after every other block of stages 2 and 3, never the
                # stage's last (rspnet_tpu/models/tsm.py:246-255)
                if non_local and stage in (1, 2) and i % 2 == 0 and i < n - 1:
                    nl = f"nl{stage + 1}_{i}"
                    setattr(self, nl, NonLocalBlock(in_planes, dtype=dtype))
                self.order.append((name, nl))
        self.new_fc = (nn.Linear(self.feature_dim, num_classes)
                       if with_classifier else None)

    def features(self, x: torch.Tensor) -> torch.Tensor:
        """NCDHW (channels-last memory) -> [B, feature_dim, T, h, w]."""
        x = self.stem(x)
        x = max_pool3d(x, (1, 3, 3), (1, 2, 2), (0, 1, 1))
        for name, nl in self.order:
            x = getattr(self, name)(x)
            if nl is not None:
                x = getattr(self, nl)(x)
        return x

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """NDHWC clip -> the consensus of the per-frame logits with
        ``new_fc``, else the mean of the per-frame pooled features; each
        mean summed in (at least) f32 and rounded once, as ``jnp.mean``."""
        feat = self.features(x.permute(0, 4, 1, 2, 3))
        per_frame = feat.mean(dim=(3, 4)).transpose(1, 2)   # [B, T, C]
        if self.new_fc is not None:
            per_frame = dense(per_frame, self.new_fc, self.dtype)
        return per_frame.mean(dim=1)


# base_model -> (stage depths, BasicBlock?) (rspnet_tpu/models/tsm.py:276)
BASE_MODELS = {
    "resnet18": ((2, 2, 2, 2), True),
    "resnet34": ((3, 4, 6, 3), True),
    "resnet50": ((3, 4, 6, 3), False),
}


def get_model_class(base_model: str = "resnet50", num_segments: int = 8,
                    non_local: bool = False, shift_groups: int = 1):
    """The constructor of the config's TSM (``model.base_model``,
    ``num_segments``, ``non_local``, ``shift_groups``)."""
    if base_model not in BASE_MODELS:
        raise ValueError(f"unknown TSM base_model {base_model!r}; "
                         f"available: {sorted(BASE_MODELS)}")
    layers, basic = BASE_MODELS[base_model]

    def ctor(num_classes: int = 174, **kw) -> TSM:
        return TSM(num_classes=num_classes, layers=layers, basic=basic,
                   num_segments=num_segments, non_local=non_local,
                   shift_groups=shift_groups, **kw)
    return ctor
