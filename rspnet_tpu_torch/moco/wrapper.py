"""MultiTaskWrapper: backbone + two projection heads, or the finetune
classifier (port of rspnet_tpu/moco/wrapper.py).

Pretrain mode: fc1 (A-VID head) and fc2 (RSP head) on the backbone's
feature map, of one ``fc_type`` (wrapper.py:21-133): ``linear`` (global
average pool, a dense layer), ``mlp`` (pool, a ``hidden`` dense layer of
the feature width, ReLU, ``linear``), ``conv`` (3^3 conv with a bias,
ReLU, another, pool, ``linear``), ``convbn`` (3^3 conv with a bias, BN,
ReLU, pool, ``linear``), or ``speednet`` (``linear`` heads, fc2 with one
output). Both outputs are L2-normalized, except speednet's fc2, which
goes through a sigmoid. Finetune mode (``finetune=True``, wrapper.py:93-94,
:130-131): one ``fc`` classifier on the pooled features, no normalization.
With a bf16 compute ``dtype`` the heads and the normalization run in bf16,
as the JAX heads do. Module names follow the JAX tree (``fc1.hidden``,
``fc1.conv1.conv``, ``fc1.conv1.bn``, ``fc1.linear``).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..models.common import ConvNorm, dense, global_avg_pool


class LinearFc(nn.Module):
    """``dense`` on the pooled features."""

    def __init__(self, in_features: int, moco_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = nn.Linear(in_features, moco_dim)
        self.dtype = dtype

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return dense(global_avg_pool(feat), self.linear, self.dtype)


class MlpFc(nn.Module):
    """pool -> ``hidden`` dense (the feature width) -> ReLU -> ``linear``
    (wrapper.py:32)."""

    def __init__(self, in_features: int, moco_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.hidden = nn.Linear(in_features, in_features)
        self.linear = nn.Linear(in_features, moco_dim)
        self.dtype = dtype

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = torch.relu(dense(global_avg_pool(feat), self.hidden, self.dtype))
        return dense(x, self.linear, self.dtype)


class ConvFc(nn.Module):
    """3^3 conv (bias) -> ReLU -> 3^3 conv (bias) -> pool -> ``linear``,
    or with ``bn`` (``convbn``) one 3^3 conv (bias) -> BN -> ReLU -> pool ->
    ``linear`` (wrapper.py:44, :60)."""

    def __init__(self, in_channels: int, moco_dim: int, bn: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        c = in_channels
        self.conv1 = ConvNorm(c, c, 3, 1, 1, use_bias=True, use_bn=bn,
                              dtype=dtype)
        self.conv2 = (None if bn else
                      ConvNorm(c, c, 3, 1, 1, use_bias=True, use_bn=False,
                               activation=False, dtype=dtype))
        self.linear = nn.Linear(c, moco_dim)
        self.dtype = dtype

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = self.conv1(feat)
        if self.conv2 is not None:
            x = self.conv2(x)
        return dense(global_avg_pool(x), self.linear, self.dtype)


def make_head(fc_type: str, in_features: int, out_features: int,
              dtype: Optional[torch.dtype]) -> nn.Module:
    if fc_type in ("linear", "speednet"):
        return LinearFc(in_features, out_features, dtype)
    if fc_type == "mlp":
        return MlpFc(in_features, out_features, dtype)
    if fc_type in ("conv", "convbn"):
        return ConvFc(in_features, out_features, fc_type == "convbn", dtype)
    raise ValueError(f"Unknown fc_type {fc_type!r}")


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) in x's dtype, rounded where ``jnp.linalg.norm``
    rounds: each square, the (f32-accumulated) sum and the square root."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class MultiTaskWrapper(nn.Module):
    """Two pretext heads over a shared backbone, or (``finetune``) one
    classifier ``fc`` with ``num_classes`` outputs."""

    def __init__(self, encoder: nn.Module, num_classes: int = 128,
                 fc_type: str = "linear", dtype: Optional[torch.dtype] = None,
                 finetune: bool = False):
        super().__init__()
        self.encoder = encoder
        self.finetune = finetune
        self.dtype = dtype
        if finetune:
            self.fc = nn.Linear(encoder.feature_dim, num_classes)
            return
        self.fc_type = fc_type
        self.fc1 = make_head(fc_type, encoder.feature_dim, num_classes, dtype)
        # speednet's RSP head is one logit through a sigmoid
        self.fc2 = make_head(fc_type, encoder.feature_dim,
                             1 if fc_type == "speednet" else num_classes,
                             dtype)

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: NDHWC clip [B, T, H, W, 3] -> (A-VID, RSP) embeddings, or
        the class logits [B, num_classes] when ``finetune``."""
        feat = self.encoder.features(x.permute(0, 4, 1, 2, 3))
        if self.finetune:
            return dense(global_avg_pool(feat), self.fc, self.dtype)
        x2 = self.fc2(feat)
        x2 = (torch.sigmoid(x2) if self.fc_type == "speednet"
              else l2_normalize(x2))
        return l2_normalize(self.fc1(feat)), x2
