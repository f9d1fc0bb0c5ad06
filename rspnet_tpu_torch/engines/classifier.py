"""Supervised classification steps (port of
rspnet_tpu/engines/classifier.py).

``group`` is the data-parallel group (None: one process, no collective):
the train step averages the gradients, the loss and the metrics over it
(classifier.py:92-94, :109-110); the eval step sums its sums over it and
gathers the logits in rank order (:156-162). Dropout masks differ by rank
through the engine's generator (seed + 1 + rank, :58-61).

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
updates), and BN runs in eval mode. The head is named by the whole first
key of a parameter, from ``PROBE_NAMES``.

Stated deviation (F11, ROADMAP.md §3): the JAX mask
(rspnet_tpu/engines/classifier.py:40-47 ``fc_only_mask``) names only
``fc``, ``linear``, ``head`` and ``new_fc``, so a ``1stream`` SlowFast,
whose classifier is ``head_fc``, trains nothing there. The port's probe
also names ``head_fc`` and trains it, following the reference's head
naming (SURVEY.md §1: pyslowfast's ``head_helper.py`` head is what the
reference's ``head`` entry names). ``FC_NAMES`` keeps JAX's four names for
the ``1stream`` overlay (``transfer.py``): a MoCo encoder has no
``head_fc``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from ..framework.metrics import accuracy, masked_topk_correct
from ..models.common import mean_dim as _mean
from ..parallel import (all_gather_rows, all_reduce_mean, all_reduce_sum,
                        combine_grads)

# top-level module names of classifier heads (classifier.py:37-43)
FC_NAMES = ("fc", "linear", "head", "new_fc")
# the linear probe's heads: JAX's four and SlowFast's ``head_fc`` (F11)
PROBE_NAMES = FC_NAMES + ("head_fc",)


def freeze_backbone(model: nn.Module) -> None:
    """``only_train_fc``: only the classifier head's parameters train."""
    for name, p in model.named_parameters():
        p.requires_grad_(name.split(".")[0] in PROBE_NAMES)


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
               generator: Optional[torch.Generator] = None,
               group=None) -> Dict[str, torch.Tensor]:
    """One SGD step on the cross entropy; returns loss, acc1, acc5 (device
    tensors; top-k clamped at the number of classes), averaged over
    ``group``. A model with a dropout head (S3D-G's ``1stream``
    classifier) keeps ``dropout_mask``, or draws its mask from
    ``generator``."""
    if only_train_fc:
        freeze_backbone(model)
    model.train(not only_train_fc)      # the linear probe pins BN to eval
    model_kw = {}
    if getattr(model, "drop_prob", None) is not None:
        model_kw = {"dropout_mask": dropout_mask, "generator": generator}
    logits = classify(model, clips, n_crop, **model_kw)
    loss = _mean(cross_entropy(logits, labels))
    optimizer.zero_grad(set_to_none=True)
    if loss.requires_grad:
        loss.backward()
        if group is not None:
            combine_grads(model.parameters(), group,
                          torch.distributed.get_world_size(group))
        optimizer.step()
    logits = logits.detach()
    acc1, acc5 = accuracy(logits, labels, topk=(1, 5))
    metrics = [loss.detach(), acc1, acc5]
    if group is not None:
        metrics = all_reduce_mean(torch.stack(
            [m.to(torch.promote_types(m.dtype, torch.float32))
             for m in metrics]), group).unbind()
    return dict(zip(("loss", "acc1", "acc5"), metrics))


@torch.no_grad()
def eval_step(model: nn.Module, clips: torch.Tensor, labels: torch.Tensor,
              mask: torch.Tensor, *, n_crop: int = 1, group=None,
              return_logits: bool = False) -> Dict[str, torch.Tensor]:
    """Eval-mode forward; the masked SUMS loss_sum, correct1, correct5 and
    count (classifier.py:118-165), summed over ``group``, so the host
    aggregates exactly over padded validation tails; ``return_logits``
    adds the logits of every rank in rank order, as the JAX
    ``make_eval_step(return_logits=True)`` does (no engine reads them).
    The model's mode comes back as it was."""
    was_training = model.training
    model.eval()
    try:
        logits = classify(model, clips, n_crop)
    finally:
        model.train(was_training)
    per_sample = cross_entropy(logits, labels)
    maskf = mask.to(torch.float32)
    correct1, correct5 = masked_topk_correct(logits, labels, mask, (1, 5))
    sums = {"loss_sum": (per_sample * maskf).sum(), "correct1": correct1,
            "correct5": correct5, "count": maskf.sum()}
    if group is not None:
        keys = list(sums)
        sums = dict(zip(keys, all_reduce_sum(torch.stack(
            [sums[k].to(torch.promote_types(sums[k].dtype, torch.float32))
             for k in keys]), group).unbind()))
    if return_logits:
        sums["logits"] = (logits if group is None
                          else all_gather_rows(logits, group))
    return sums
