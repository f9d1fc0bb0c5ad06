"""Supervised classification steps on one card (port of
rspnet_tpu/engines/classifier.py, ``axis_name=None``).

Multi-crop clips arrive time-concatenated ``[B, n_crop*T, S, S, C]``; the
steps fold the crops into the batch axis and average the logits over
crops (classifier.py:63-80; reference finetune.py:44-61).

The loss is optax's ``softmax_cross_entropy_with_integer_labels`` in the
logits' dtype, as the JAX step computes it on bf16 logits: logsumexp
(max, exp of the shifted logits, an f32 sum rounded once, log, plus the
max) minus the label's logit, each step rounded to that dtype; its batch
mean and the crop mean sum in f32 and round once, as ``jnp.mean`` does.

Linear probe (``only_train_fc``, classifier.py:87-103): every parameter
outside the classifier head gets ``requires_grad=False``, so SGD applies
neither gradient nor weight decay to it (JAX masks the gradients and the
updates), and BN runs in eval mode.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..framework.metrics import accuracy, masked_topk_correct

# top-level module names of classifier heads (classifier.py:37-43)
FC_NAMES = ("fc", "linear", "head", "new_fc")


def freeze_backbone(model: nn.Module) -> None:
    """``only_train_fc``: only the classifier head's parameters train."""
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] in FC_NAMES)


def _mean(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.mean``: summed in at least f32, rounded once to x's dtype."""
    acc = x.to(torch.promote_types(x.dtype, torch.float32))
    return (acc.mean() if dim is None else acc.mean(dim)).to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor
                  ) -> torch.Tensor:
    """Per-sample softmax cross entropy with integer labels [B], in the
    logits' dtype (optax's logsumexp - label logit)."""
    amax = logits.detach().amax(dim=-1, keepdim=True)
    exp_a = torch.exp(logits - amax)
    sumexp = exp_a.to(torch.promote_types(exp_a.dtype, torch.float32)).sum(
        dim=-1).to(logits.dtype)
    lse = torch.log(sumexp) + amax[:, 0]
    return lse - logits.gather(-1, labels.long()[:, None])[:, 0]


def classify(model: nn.Module, clips: torch.Tensor, n_crop: int = 1,
             **model_kw) -> torch.Tensor:
    """[B, n_crop*T, S, S, C] -> logits [B, C], averaged over the crops.
    The model is a finetune ``MultiTaskWrapper`` or (``1stream``) a bare
    backbone with its own classifier, whose output is its logits (TSM's
    the consensus mean over frames)."""
    B = clips.shape[0]
    x = clips
    if n_crop > 1:
        T = clips.shape[1] // n_crop
        x = clips.reshape((B * n_crop, T) + tuple(clips.shape[2:]))
    out = model(x, **model_kw)
    if n_crop > 1:
        out = _mean(out.reshape(B, n_crop, -1), dim=1)
    return out


def train_step(model: nn.Module, optimizer: torch.optim.Optimizer,
               clips: torch.Tensor, labels: torch.Tensor, *,
               n_crop: int = 1, only_train_fc: bool = False,
               dropout_mask: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None
               ) -> Dict[str, torch.Tensor]:
    """One SGD step on the cross entropy; returns loss, acc1, acc5 (device
    tensors; top-k clamped at the number of classes). A model with a
    dropout head (S3D-G's ``1stream`` classifier) keeps ``dropout_mask``,
    or draws its mask from ``generator``."""
    if only_train_fc:
        freeze_backbone(model)
    model.train(not only_train_fc)      # the linear probe pins BN to eval
    model_kw = {}
    if getattr(model, "drop_prob", None) is not None:
        model_kw = {"dropout_mask": dropout_mask, "generator": generator}
    logits = classify(model, clips, n_crop, **model_kw)
    loss = _mean(cross_entropy(logits, labels))
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    logits = logits.detach()
    acc1, acc5 = accuracy(logits, labels, topk=(1, 5))
    return {"loss": loss.detach(), "acc1": acc1, "acc5": acc5}


@torch.no_grad()
def eval_step(model: nn.Module, clips: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor, *, n_crop: int = 1
              ) -> Dict[str, torch.Tensor]:
    """Eval-mode forward; the masked SUMS loss_sum, correct1, correct5 and
    count (classifier.py:118-165), so the host aggregates exactly over
    padded validation tails. The model's mode comes back as it was."""
    was_training = model.training
    model.eval()
    try:
        logits = classify(model, clips, n_crop)
    finally:
        model.train(was_training)
    per_sample = cross_entropy(logits, labels)
    maskf = mask.to(torch.float32)
    correct1, correct5 = masked_topk_correct(logits, labels, mask, (1, 5))
    return {"loss_sum": (per_sample * maskf).sum(), "correct1": correct1,
            "correct5": correct5, "count": maskf.sum()}
