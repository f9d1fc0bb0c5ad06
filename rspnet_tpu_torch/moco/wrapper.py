"""MultiTaskWrapper: backbone + two projection heads (port of
rspnet_tpu/moco/wrapper.py, pretrain mode, ``fc_type: linear``).

fc1 (A-VID head) and fc2 (RSP head) each global-average-pool the backbone's
feature map and project it linearly; both outputs are L2-normalized.
With a bf16 compute ``dtype`` the heads and the normalization run in bf16,
as the JAX heads do (wrapper.py:21-28, :76).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..models.common import global_avg_pool


class LinearFc(nn.Module):
    """flax ``nn.Dense(dtype=...)`` on the pooled features: input, weight
    and bias cast to ``dtype``, the bias added to the rounded product."""

    def __init__(self, in_features: int, moco_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = nn.Linear(in_features, moco_dim)
        self.dtype = dtype

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        x = global_avg_pool(feat)
        dt = self.dtype or x.dtype
        return (F.linear(x.to(dt), self.linear.weight.to(dt))
                + self.linear.bias.to(dt))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) in x's dtype, rounded where ``jnp.linalg.norm``
    rounds: each square, the (f32-accumulated) sum and the square root."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    return x / torch.clamp(norm, min=eps)


class MultiTaskWrapper(nn.Module):
    """Two pretext heads over a shared backbone."""

    def __init__(self, encoder: nn.Module, num_classes: int = 128,
                 fc_type: str = "linear", dtype: Optional[torch.dtype] = None):
        super().__init__()
        if fc_type != "linear":
            raise NotImplementedError(
                f"fc_type {fc_type!r} is not ported yet (linear only)")
        self.encoder = encoder
        self.fc1 = LinearFc(encoder.feature_dim, num_classes, dtype)
        self.fc2 = LinearFc(encoder.feature_dim, num_classes, dtype)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: NDHWC clip [B, T, H, W, 3] -> (A-VID, RSP) embeddings."""
        feat = self.encoder.features(x.permute(0, 4, 1, 2, 3))
        return l2_normalize(self.fc1(feat)), l2_normalize(self.fc2(feat))
