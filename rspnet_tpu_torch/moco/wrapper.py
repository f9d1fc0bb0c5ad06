"""MultiTaskWrapper: backbone + two projection heads (port of
rspnet_tpu/moco/wrapper.py, pretrain mode, ``fc_type: linear``).

fc1 (A-VID head) and fc2 (RSP head) each global-average-pool the backbone's
feature map and project it linearly; both outputs are L2-normalized.
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..models.common import global_avg_pool


class LinearFc(nn.Module):
    def __init__(self, in_features: int, moco_dim: int):
        super().__init__()
        self.linear = nn.Linear(in_features, moco_dim)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return self.linear(global_avg_pool(feat))


def l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True),
                           min=eps)


class MultiTaskWrapper(nn.Module):
    """Two pretext heads over a shared backbone."""

    def __init__(self, encoder: nn.Module, num_classes: int = 128,
                 fc_type: str = "linear"):
        super().__init__()
        if fc_type != "linear":
            raise NotImplementedError(
                f"fc_type {fc_type!r} is not ported yet (linear only)")
        self.encoder = encoder
        self.fc1 = LinearFc(encoder.feature_dim, num_classes)
        self.fc2 = LinearFc(encoder.feature_dim, num_classes)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: NDHWC clip [B, T, H, W, 3] -> (A-VID, RSP) embeddings."""
        feat = self.encoder.features(x.permute(0, 4, 1, 2, 3))
        return l2_normalize(self.fc1(feat)), l2_normalize(self.fc2(feat))
