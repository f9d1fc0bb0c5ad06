"""Classification metrics (port of rspnet_tpu/framework/metrics.py).

Counts and percentages are at least f32 whatever the logits' dtype, as
the JAX metrics cast their hit masks to f32, and ties rank as in
``jax.lax.top_k``.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


def _count_dtype(output: torch.Tensor) -> torch.dtype:
    return torch.promote_types(output.dtype, torch.float32)


def _hits(output: torch.Tensor, target: torch.Tensor,
          topk: Sequence[int]) -> torch.Tensor:
    """[B, min(max(topk), C)] bool: the label is the j-th prediction. Equal
    logits rank by class index, as ``jax.lax.top_k`` ranks them (bf16
    logits tie often)."""
    maxk = min(max(topk), output.shape[-1])
    pred = torch.sort(output, dim=-1, descending=True,
                      stable=True).indices[:, :maxk]
    return pred == target[:, None]


def accuracy(output: torch.Tensor, target: torch.Tensor,
             topk: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """Top-k accuracy in percent over the batch; k is clamped at the number
    of classes. output: [B, C] logits; target: [B] int labels."""
    correct = _hits(output, target, topk)
    batch_size = target.shape[0]
    dt = _count_dtype(output)
    return [correct[:, :min(k, correct.shape[1])].to(dt).sum()
            * (100.0 / batch_size) for k in topk]


def masked_topk_correct(output: torch.Tensor, target: torch.Tensor,
                        mask: torch.Tensor,
                        topk: Sequence[int] = (1,)) -> List[torch.Tensor]:
    """Per k, the number of valid rows (``mask`` [B] bool) whose label is
    among the top k logits: the eval step's sums
    (rspnet_tpu/engines/classifier.py:152-156)."""
    correct = _hits(output, target, topk) & mask[:, None]
    dt = _count_dtype(output)
    return [correct[:, :min(k, correct.shape[1])].to(dt).sum() for k in topk]
