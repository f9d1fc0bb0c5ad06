"""Classification metrics (port of rspnet_tpu/framework/metrics.py)."""
from __future__ import annotations

from typing import List, Sequence

import torch


def accuracy(output: torch.Tensor, target: torch.Tensor,
             topk: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """Top-k accuracy in percent over the batch; k is clamped at the number
    of classes. output: [B, C] logits; target: [B] int labels."""
    maxk = min(max(topk), output.shape[-1])
    batch_size = target.shape[0]
    _, pred = torch.topk(output, maxk, dim=-1)
    correct = pred == target[:, None]
    return [correct[:, :min(k, maxk)].to(output.dtype).sum()
            * (100.0 / batch_size) for k in topk]
