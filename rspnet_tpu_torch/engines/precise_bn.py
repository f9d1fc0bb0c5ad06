"""Precise-BN: replace each BatchNorm's running statistics by the average
of its true per-batch statistics over calibration batches (port of
rspnet_tpu/engines/precise_bn.py; reference: slowfast defaults.py:26-30,
fvcore ``update_bn_stats``).

PyTorch's own idiom, not the JAX package's two-pass momentum recovery:
each BN's running statistics are reset and its ``momentum`` set to None,
so that torch keeps a cumulative average; the batches run in train mode
under ``no_grad``; the momenta, the modes and the batch counters come back
afterwards. The result is the mean of the batch means and of the unbiased
batch variances, what ``recalibrate_batch_stats`` computes (:59). Under
more than one rank each BN takes its batch moments over its process group
(``BatchNorm.process_group``), so every rank ends with the statistics of
the global batches, as ``make_stats_fn``'s cross-replica forward gives
them (:38-46).

Deviations from the JAX package, each stated (ROADMAP.md §3, F6):
- a BN that no calibration forward runs keeps its statistics; the JAX
  package divides its never-updated leaf to mean 0 and var 0 (:79);
- ``SubBatchNorm`` (per-replica statistics, :55) raises
  ``NotImplementedError`` (F6);
- the batch iterable is closed when recalibration ends, also when it
  raises, so a loader generator does not stay suspended
  (rspnet_tpu/engines/finetune.py:240); on a failure every BN gets its
  statistics back.
"""
from __future__ import annotations

from typing import Iterable

import torch
from torch import nn


def _check_supported(model: nn.Module) -> None:
    for m in model.modules():
        if type(m).__name__ == "SubBatchNorm":
            raise NotImplementedError(
                "precise-BN over SubBatchNorm (per-replica statistics) is "
                "not ported (see ROADMAP.md)")


def recalibrate_bn_stats(model: nn.Module,
                         batches: Iterable[torch.Tensor]) -> int:
    """Run ``model`` on each clip batch of ``batches`` and leave in every
    BN the mean of its per-batch statistics; returns the number of
    batches. ``batches`` is closed at the end if it has ``close``."""
    try:
        _check_supported(model)
        bns = [m for m in model.modules()
               if isinstance(m, nn.modules.batchnorm._BatchNorm)
               and m.track_running_stats]
        saved = [(bn.momentum, bn.running_mean.clone(),
                  bn.running_var.clone(), bn.num_batches_tracked.clone())
                 for bn in bns]
        was_training = model.training
        n = 0
        try:
            for bn in bns:
                bn.reset_running_stats()
                bn.momentum = None        # cumulative average
            model.train()
            with torch.no_grad():
                for clips in batches:
                    model(clips)
                    n += 1
            if n == 0:
                raise ValueError("precise-BN: no calibration batches")
            for bn, (_, mean, var, _) in zip(bns, saved):
                if int(bn.num_batches_tracked) == 0:   # never ran: keep
                    bn.running_mean.copy_(mean)
                    bn.running_var.copy_(var)
        except BaseException:
            for bn, (_, mean, var, _) in zip(bns, saved):
                bn.running_mean.copy_(mean)
                bn.running_var.copy_(var)
            raise
        finally:
            for bn, (momentum, _, _, count) in zip(bns, saved):
                bn.momentum = momentum
                bn.num_batches_tracked.copy_(count)
            model.train(was_training)
        return n
    finally:
        close = getattr(batches, "close", None)
        if close is not None:
            close()
