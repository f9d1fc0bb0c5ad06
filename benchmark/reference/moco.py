"""Plain MoCo + relative-speed-perception training steps, float32.

One step, as RSPNet defines it (Chen et al. 2021, "RSPNet: Relative
Speed Perception for Unsupervised Video Representation Learning"), with
the key encoder's two batches in one forward pass:

1. the key encoder's parameters become m * key + (1 - m) * query;
2. the 32-frame windows are played at two speeds: a random half of the
   batch (the last half of a random permutation) plays at speed 2 (every
   second frame), the rest at speed 1 (the first 16 frames); the query and
   the positive key play at the clip's own speed, the negative key at the
   other one;
3. the key encoder (no gradient, batch statistics over the 2B clips of
   the positive and the negative keys) embeds both keys;
4. the query encoder embeds the query; the A-VID loss is the InfoNCE of
   the positive key (and again of the negative key) against the queue at
   temperature t, the RSP loss the margin ranking max(0, margin - (q.k+ -
   q.k-) / t) of the speed heads;
5. SGD with momentum and weight decay on the summed loss;
6. the negative keys' A-VID embeddings enter the ring queue.

``run_steps`` returns what the benchmark compares: each step's loss, the
first step's gradient, the parameters of both encoders after the last
step and the enqueued keys.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from . import augment as aug
from . import models


@dataclass
class StepConfig:
    arch: str
    size: int                  # spatial size of the network input
    dim: int                   # embedding width
    m: float                   # EMA momentum
    t: float                   # temperature
    margin: float
    lr: float
    momentum: float
    weight_decay: float
    mean: Sequence[float]
    std: Sequence[float]
    speed: int = 2
    lambda_a: float = 1.0
    lambda_m: float = 1.0


@dataclass
class Result:
    losses: List[float]
    grad1: Dict[str, torch.Tensor]      # first step's gradient, per leaf
    q: Dict[str, torch.Tensor]          # query encoder after the last step
    k: Dict[str, torch.Tensor]          # key encoder after the last step
    keys: torch.Tensor                  # [steps * B, dim] enqueued keys


def gather_speeds(q, k, perm, speed):
    """-> (query, positive key, negative key) clips [B, T // speed, ...]."""
    B, T = q.shape[:2]
    n = T // speed
    fast = torch.zeros(B, dtype=torch.bool, device=q.device)
    fast[perm[B // 2:]] = True
    slow_idx = torch.arange(n, device=q.device)
    fast_idx = torch.arange(0, T, speed, device=q.device)[:n]
    same = torch.where(fast[:, None], fast_idx, slow_idx)
    other = torch.where(fast[:, None], slow_idx, fast_idx)
    rows = torch.arange(B, device=q.device)[:, None]
    return q[rows, same], k[rows, same], k[rows, other]


def loss_fn(q_a, q_m, k_a, k_m, kn_a, kn_m, queue, c: StepConfig):
    neg = q_a @ queue
    labels = torch.zeros(q_a.shape[0], dtype=torch.long, device=q_a.device)
    loss_a = sum(F.cross_entropy(
        torch.cat([(q_a * pos).sum(1, keepdim=True), neg], 1) / c.t, labels)
        for pos in (k_a, kn_a))
    gap = ((q_m * k_m).sum(1) - (q_m * kn_m).sum(1)) / c.t
    loss_m = torch.clamp(c.margin - gap, min=0).mean()
    return c.lambda_a * loss_a + c.lambda_m * loss_m


def step(model_q, model_k, queue, ptr, q_view, k_view, perm, bufs,
         c: StepConfig):
    """One step on augmented clips [B, T, S, S, 3]; updates the encoders,
    the momentum buffers ``bufs`` and the queue in place. Returns (loss,
    gradients by leaf name, the enqueued keys, the new queue pointer)."""
    B = q_view.shape[0]
    names = [n for n, _ in model_q.named_parameters()]
    with torch.no_grad():
        for pk, pq in zip(model_k.parameters(), model_q.parameters()):
            pk.mul_(c.m).add_(pq * (1 - c.m))
    q_in, k_in, kn_in = gather_speeds(q_view, k_view, perm, c.speed)
    with torch.no_grad():
        k_a, k_m = model_k(torch.cat([k_in, kn_in]))
    q_a, q_m = model_q(q_in)
    loss = loss_fn(q_a, q_m, k_a[:B], k_m[:B], k_a[B:], k_m[B:], queue, c)
    grads = torch.autograd.grad(loss, list(model_q.parameters()))
    with torch.no_grad():
        for n, p, g in zip(names, model_q.parameters(), grads):
            d = g + c.weight_decay * p
            bufs[n] = d if n not in bufs else bufs[n] * c.momentum + d
            p.sub_(c.lr * bufs[n])
        keys = k_a[B:].detach()
        queue[:, ptr:ptr + B] = keys.T
    return (loss.detach(), dict(zip(names, grads)), keys,
            (ptr + B) % queue.shape[1])


def run_steps(c: StepConfig, state: Dict[str, torch.Tensor],
              queue: torch.Tensor, batches, augment_rng: np.random.Generator,
              perm_gen: torch.Generator, device,
              quant: Optional[Callable] = None) -> Result:
    """``len(batches)`` steps from the weights ``state`` (both encoders
    start equal) and the unit-column queue [dim, K]. ``batches`` yields
    (query clips, key clips) uint8 [B, T, H, W, 3] on the host; the
    augment draws come from ``augment_rng``, the permutations from
    ``perm_gen``, in the program's order (query params, key params, then
    the permutation and the speed row)."""
    model_q = models.build(c.arch, c.dim).to(device)
    model_q.load_state_dict(state)
    model_k = models.build(c.arch, c.dim).to(device)
    model_k.load_state_dict(state)
    for p in model_k.parameters():
        p.requires_grad_(False)
    model_q.set_quant(quant)
    model_k.set_quant(quant)
    queue = queue.clone()
    ptr = 0
    bufs = {}
    losses, keys = [], []
    grad1 = None
    for clip_q, clip_k in batches:
        B, _, H, W, _ = clip_q.shape
        views = []
        for clip in (clip_q, clip_k):
            p = aug.draw_params(augment_rng, B, H, W)
            views.append(aug.augment(clip.to(device), p, c.size, c.mean,
                                     c.std))
        perm = torch.randperm(B, generator=perm_gen, device=perm_gen.device)
        torch.randint(1, (), generator=perm_gen, device=perm_gen.device)
        loss, grads, k, ptr = step(model_q, model_k, queue, ptr, views[0],
                                   views[1], perm.to(device), bufs, c)
        del views
        if grad1 is None:
            grad1 = {n: g.detach().clone() for n, g in grads.items()}
        keys.append(k)
        losses.append(float(loss))
    return Result(losses, grad1,
                  {n: p.detach() for n, p in model_q.named_parameters()},
                  {n: p.detach() for n, p in model_k.named_parameters()},
                  torch.cat(keys))
