"""MultiTaskWrapper: backbone + two projection heads, or the finetune
classifier (port of rspnet_tpu/moco/wrapper.py, ``fc_type: linear``).

Pretrain mode: fc1 (A-VID head) and fc2 (RSP head) each global-average-pool
the backbone's feature map and project it linearly; both outputs are
L2-normalized. Finetune mode (``finetune=True``, wrapper.py:93-94,
:130-131): one ``fc`` classifier on the pooled features, no normalization.
With a bf16 compute ``dtype`` the heads and the normalization run in bf16,
as the JAX heads do (wrapper.py:21-28, :76).
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
from torch import nn

from ..models.common import dense, global_avg_pool


class LinearFc(nn.Module):
    """``dense`` on the pooled features."""

    def __init__(self, in_features: int, moco_dim: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.linear = nn.Linear(in_features, moco_dim)
        self.dtype = dtype

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        return dense(global_avg_pool(feat), self.linear, self.dtype)


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
        if fc_type != "linear":
            raise NotImplementedError(
                f"fc_type {fc_type!r} is not ported yet (linear only)")
        self.fc1 = LinearFc(encoder.feature_dim, num_classes, dtype)
        self.fc2 = LinearFc(encoder.feature_dim, num_classes, dtype)

    def forward(self, x: torch.Tensor
                ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """x: NDHWC clip [B, T, H, W, 3] -> (A-VID, RSP) embeddings, or
        the class logits [B, num_classes] when ``finetune``."""
        feat = self.encoder.features(x.permute(0, 4, 1, 2, 3))
        if self.finetune:
            return dense(global_avg_pool(feat), self.fc, self.dtype)
        return l2_normalize(self.fc1(feat)), l2_normalize(self.fc2(feat))
