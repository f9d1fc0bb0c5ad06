"""Epoch-level LR schedules and the optimizer (port of
rspnet_tpu/framework/lr_schedule.py).

The reference steps torch schedulers once per epoch (reference:
pretrain.py:238, finetune.py:390-393): CosineAnnealingLR, MultiStepLR,
ReduceLROnPlateau, or none. The schedule is a small host object; the engine
writes ``schedule.lr`` into the optimizer's param groups each epoch.
"""
from __future__ import annotations

import math
from typing import Optional


class LRScheduler:
    def __init__(self, base_lr: float):
        self.base_lr = base_lr
        self.lr = base_lr
        self.epoch = 0

    def step(self, metric: Optional[float] = None) -> float:
        """Advance one epoch; returns the new lr."""
        self.epoch += 1
        self.lr = self._compute()
        return self.lr

    def _compute(self) -> float:
        return self.base_lr

    def state_dict(self) -> dict:
        return {"epoch": self.epoch, "lr": self.lr, "base_lr": self.base_lr}

    def load_state_dict(self, d: dict) -> None:
        self.epoch = int(d["epoch"])
        self.lr = float(d["lr"])
        self.base_lr = float(d.get("base_lr", self.base_lr))


class CosineLR(LRScheduler):
    """CosineAnnealingLR(T_max=num_epochs), epoch-stepped.

    Both reference engines floor at eta_min=lr/1000 (pretrain.py:75-79,
    finetune.py:224-228).
    """

    def __init__(self, base_lr: float, num_epochs: int, eta_min: float = 0.0):
        self.num_epochs = max(1, num_epochs)
        self.eta_min = eta_min
        super().__init__(base_lr)

    def _compute(self) -> float:
        return self.eta_min + (self.base_lr - self.eta_min) * 0.5 * (
            1.0 + math.cos(math.pi * self.epoch / self.num_epochs))


class MultiStepLR(LRScheduler):
    """Decay by gamma at each milestone epoch."""

    def __init__(self, base_lr: float, milestones, gamma: float = 0.1):
        self.milestones = sorted(int(m) for m in milestones)
        self.gamma = gamma
        super().__init__(base_lr)

    def _compute(self) -> float:
        passed = sum(1 for m in self.milestones if self.epoch >= m)
        return self.base_lr * (self.gamma ** passed)


class PlateauLR(LRScheduler):
    """ReduceLROnPlateau(min mode): decay when the metric stops improving.

    Uses torch's default RELATIVE threshold (improvement counts only if
    metric < best * (1 - threshold), threshold=1e-4,
    threshold_mode='rel') — an absolute epsilon would treat 1e-8 noise
    on a plateau as progress and never decay.
    """

    def __init__(self, base_lr: float, patience: int = 10,
                 factor: float = 0.1, threshold: float = 1e-4):
        self.patience = patience
        self.factor = factor
        self.threshold = threshold
        self.best = float("inf")
        self.bad_epochs = 0
        super().__init__(base_lr)

    def step(self, metric: Optional[float] = None) -> float:
        self.epoch += 1
        if metric is not None:
            if metric < self.best * (1.0 - self.threshold):
                self.best = metric
                self.bad_epochs = 0
            else:
                self.bad_epochs += 1
                if self.bad_epochs > self.patience:
                    self.lr = self.lr * self.factor
                    self.bad_epochs = 0
        return self.lr

    def state_dict(self) -> dict:
        d = super().state_dict()
        d.update(best=self.best, bad_epochs=self.bad_epochs)
        return d

    def load_state_dict(self, d: dict) -> None:
        super().load_state_dict(d)
        self.best = float(d.get("best", float("inf")))
        self.bad_epochs = int(d.get("bad_epochs", 0))


def build_scheduler(schedule: str, base_lr: float, *, num_epochs: int = 1,
                    milestones=(), patience: int = 10,
                    eta_min: float = 0.0) -> LRScheduler:
    if schedule == "cosine":
        return CosineLR(base_lr, num_epochs, eta_min=eta_min)
    if schedule == "multi_step":
        return MultiStepLR(base_lr, milestones)
    if schedule == "plateau":
        return PlateauLR(base_lr, patience)
    if schedule in ("none", None, ""):
        return LRScheduler(base_lr)
    raise ValueError(f"Unknown schedule {schedule!r}")


def build_optimizer(opt_cfg, params, lr: float):
    """ConfigTree optimizer.* -> a torch optimizer over ``params``
    (rspnet_tpu/framework/lr_schedule.py:126-198).

    ``sgd`` (the default): weight decay on ALL params, momentum, dampening
    and nesterov with torch.optim.SGD semantics, which the JAX package
    reproduces with add_decayed_weights + sgd / _trace_with_dampening.
    ``adam``: ``optax.adam(lr, eps)``, betas (0.9, 0.999) and no weight
    decay; as in JAX only ``lr`` and ``eps`` are read, so a
    ``weight_decay`` that a merged config still carries is ignored.
    """
    import torch

    opt_type = opt_cfg.get_string("type", "sgd")
    if opt_type == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999),
                                eps=opt_cfg.get_float("eps", 1e-8),
                                weight_decay=0.0)
    if opt_type != "sgd":
        raise ValueError(f"Unknown optimizer type {opt_type!r}")
    dampening = opt_cfg.get_float("dampening", 0.0)
    nesterov = opt_cfg.get_bool("nesterov", False)
    if dampening and nesterov:
        raise ValueError(
            "nesterov requires dampening=0 (torch.optim.SGD semantics)")
    return torch.optim.SGD(
        params, lr=lr, momentum=opt_cfg.get_float("momentum", 0.9),
        dampening=dampening, nesterov=nesterov,
        weight_decay=opt_cfg.get_float("weight_decay", 0.0))


def set_opt_lr(optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
