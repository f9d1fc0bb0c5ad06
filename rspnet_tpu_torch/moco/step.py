"""MoCo + relative-speed pretraining step on one device (port of the 1-D,
``axis_name=None`` path of rspnet_tpu/moco/step_core.py and builder.py).

One step, in the JAX package's order (step_core.py:313-378):

  EMA of the key encoder -> dual-speed temporal gather -> ONE fused 2B
  no-grad key pass -> query forward + A-VID InfoNCE + margin ranking ->
  backward -> SGD -> ring enqueue of the negative keys -> metrics

Each stage but the metrics is a phase of ``framework/tracing.py`` (while a
profiler runs): ``rsp.step.ema``, ``.gather``, ``.key_pass``,
``.q_forward`` (query pass and objective), ``.backward``, ``.optimizer``
(gradient combine and SGD) and ``.enqueue``.

The fused key pass computes the key encoder's BN statistics over the
concatenated 2B batch (real and negative keys together), as the JAX
package does; the reference ran two B-batch passes. Randomness: the
permutation that picks the fast half and the speed row are drawn from a
``torch.Generator`` unless the caller passes them in (the parity tests feed
the JAX step's draws). ``eval_step`` is the ``--validate`` counterpart: the
same metrics from eval-mode encoders, with nothing updated.

Exact multi-speed (``len(diff_speed) > 1``): the engine draws a speed s
each step and calls ``train_step`` / ``eval_step`` with the single-speed
branch ``speed_branch_config(cfg, s)``, which trains at the reference's
T_real = T // s (rspnet_tpu/moco/builder.py:188-207; JAX compiles one step
per branch, eager torch needs none). Every state tensor has the same shape
in each branch, so the branches share one ``MoCoState``. Packed frames
(``packed_frames``): the loader ships only the positions of
``packed_frame_subset`` and the gather addresses them through
``searchsorted``.

Layouts (port of rspnet_tpu/moco/step_core.py:240-265 ``StepLayout``): the
step body is written once and a ``StepLayout`` injects only the
collectives: the A-VID loss and its accuracies, the loss scale, the
gradient combine, the key gather before the enqueue, the enqueue and the
metric mean. ``SINGLE`` (one process) takes none; ``data_parallel_layout``
is the 1-D mesh (builder.py:103-133), ``moco/sharded_queue.py`` the 2-D
one with the K-sharded queue. Each rank draws its own permutation (the
engine seeds its generator with seed + 1 + rank); the fused 2B key pass
takes its BN moments over the whole group (``BatchNorm.process_group``,
F2). The gradient mean is an explicit ``all_reduce`` of one flat buffer
after ``backward``, not DDP: DDP would rename the parameters under
``module.`` (the checkpoints keep the reference's names), broadcast the
buffers every forward and need ``find_unused_parameters`` for the branch
heads, and JAX's ``pmean`` is that one reduction.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass, replace
from typing import Callable, Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..framework import tracing
from ..framework.metrics import accuracy
from ..parallel import all_gather_rows, all_reduce_mean, combine_grads
from .wrapper import MultiTaskWrapper

METRIC_KEYS = ["loss", "loss_A", "loss_M", "acc1_A", "acc5_A",
               "acc1_A_n", "acc5_A_n", "acc1_M"]


@dataclass(frozen=True)
class MoCoConfig:
    dim: int = 128
    k: int = 16384
    m: float = 0.999
    t: float = 0.07
    diff_speed: Tuple[int, ...] = (2,)
    fc_type: str = "linear"
    loss_lambda_a: float = 1.0
    loss_lambda_m: float = 1.0
    margin: float = 2.0          # reference: pretrain.py:49-53
    alpha: float = 0.5           # batch split fraction (reference :334)
    # the loader ships only packed_frame_subset's positions; t_load is the
    # unpacked window length (temporal_transforms.size)
    packed_frames: bool = False
    t_load: Optional[int] = None
    # a single-speed branch of exact multi-speed: the speeds the loader
    # packed for (the exact union); None: packed_frame_subset(t_load,
    # diff_speed)
    pack_speeds: Optional[Tuple[int, ...]] = None


@dataclass
class MoCoState:
    """Training state; the tensors live on the training device."""
    model_q: MultiTaskWrapper
    model_k: MultiTaskWrapper
    queue: torch.Tensor          # [dim, K], L2-normalized columns
    queue_ptr: int
    optimizer: torch.optim.Optimizer
    step: int = 0


def init_moco_state(model: MultiTaskWrapper, cfg: MoCoConfig,
                    optimizer: torch.optim.Optimizer,
                    generator: torch.Generator) -> MoCoState:
    """Key encoder = copy of the query encoder; random unit-column queue."""
    model_k = copy.deepcopy(model)
    for p in model_k.parameters():
        p.requires_grad_(False)
    dev = next(model.parameters()).device
    queue = torch.randn((cfg.dim, cfg.k), generator=generator,
                        device=generator.device).to(dev)
    queue = queue / torch.linalg.vector_norm(queue, dim=0, keepdim=True)
    return MoCoState(model, model_k, queue, 0, optimizer)


@torch.no_grad()
def momentum_update(model_q: nn.Module, model_k: nn.Module, m: float) -> None:
    """EMA of the key encoder's parameters (not its BN buffers)
    (reference :337-343)."""
    for pk, pq in zip(model_k.parameters(), model_q.parameters()):
        pk.mul_(m).add_(pq * (1.0 - m))


def real_clip_len(T: int, diff_speed: Sequence[int]) -> int:
    if not diff_speed:
        raise ValueError("moco.diff_speed must be non-empty")
    return T // max(diff_speed)


def speed_index_sets(T: int, diff_speed: Sequence[int]) -> np.ndarray:
    """[n_speeds, T // max(diff_speed)]: row i is
    arange(0, T, diff_speed[i])[:T_real] (step_core.py:123-131)."""
    t_real = real_clip_len(T, diff_speed)
    return np.stack([np.arange(0, T, s)[:t_real] for s in diff_speed])


def packed_frame_subset(T: int, diff_speed: Sequence[int],
                        exact: bool = False) -> np.ndarray:
    """Sorted union of the window positions any speed row can touch
    (step_core.py:134-159): with ``exact`` each speed s needs its own slow
    window range(T // s) and its fast row (multi-speed, T_real = T // s);
    otherwise every row is T // max(diff_speed) long."""
    need = set()
    for s in diff_speed:
        t_real = T // s if exact else real_clip_len(T, diff_speed)
        need.update(range(t_real))
        need.update(range(0, T, s)[:t_real])
    return np.asarray(sorted(need), np.int64)


def speed_branch_config(cfg: MoCoConfig, speed: int) -> MoCoConfig:
    """The single-speed branch of an exact multi-speed config
    (step_core.py:228-237); with packed frames it addresses the exact
    union the loader packed (``pack_speeds``)."""
    return replace(cfg, diff_speed=(speed,),
                   pack_speeds=(tuple(cfg.diff_speed) if cfg.packed_frames
                                else None))


def diff_speed_gather(im_q: torch.Tensor, im_k: torch.Tensor,
                      cfg: MoCoConfig, *, perm: Optional[torch.Tensor] = None,
                      speed_index: Optional[int] = None,
                      generator: Optional[torch.Generator] = None):
    """Dual-speed subsampling (reference _diff_speed :421-447).

    im_q, im_k: [B, T, H, W, C] ([B, P, H, W, C] with ``packed_frames``,
    P = len(packed_frame_subset(t_load, ...))). Returns (q_real, k_real,
    k_negative), each [B, T // max(diff_speed), H, W, C]: the samples
    ``perm[B*alpha:]`` play at the fast speed, the rest at normal speed,
    and the negative key plays at the opposite speed of its query.
    """
    B = im_q.shape[0]
    dev = im_q.device
    if cfg.packed_frames and cfg.t_load is None:
        raise ValueError("moco.packed_frames needs t_load, the unpacked "
                         "window length (temporal_transforms.size)")
    T = cfg.t_load if cfg.packed_frames else im_q.shape[1]
    t_real = real_clip_len(T, cfg.diff_speed)
    speed1 = np.arange(t_real)
    table = speed_index_sets(T, cfg.diff_speed)
    if cfg.packed_frames:
        # window positions -> positions within the packed subset
        subset = (packed_frame_subset(T, cfg.pack_speeds, exact=True)
                  if cfg.pack_speeds is not None
                  else packed_frame_subset(T, cfg.diff_speed))
        if im_q.shape[1] != len(subset):
            raise ValueError(
                f"packed input has {im_q.shape[1]} frames, the subset needs "
                f"{len(subset)} (t_load={T}, diff_speed={cfg.diff_speed})")
        speed1 = np.searchsorted(subset, speed1)
        table = np.searchsorted(subset, table)
    if perm is None:
        perm = torch.randperm(B, generator=generator,
                              device=generator.device)
    if speed_index is None:
        speed_index = int(torch.randint(len(cfg.diff_speed), (),
                                        generator=generator,
                                        device=generator.device))
    perm = torch.as_tensor(perm, device=dev, dtype=torch.long)
    is_fast = torch.zeros(B, dtype=torch.bool, device=dev)
    is_fast[perm[int(B * cfg.alpha):]] = True
    speed1 = torch.from_numpy(speed1).to(dev)
    speed2 = torch.from_numpy(table[speed_index]).to(dev)
    idx_same = torch.where(is_fast[:, None], speed2[None], speed1[None])
    idx_opp = torch.where(is_fast[:, None], speed1[None], speed2[None])
    rows = torch.arange(B, device=dev)[:, None]
    return im_q[rows, idx_same], im_k[rows, idx_same], im_k[rows, idx_opp]


@torch.no_grad()
def key_pass(model_k: MultiTaskWrapper, k_real: torch.Tensor,
             k_neg: torch.Tensor):
    """ONE fused 2B forward of the key encoder in train mode (BN statistics
    over both key batches together, rspnet_tpu step_core.py:281-293)."""
    b = k_real.shape[0]
    k_a, k_m = model_k(torch.cat([k_real, k_neg], dim=0))
    return k_a[:b], k_m[:b], k_a[b:], k_m[b:]


def avid_loss_dense(q_a, k_a, k_neg_a, queue, cfg: MoCoConfig):
    """A-VID InfoNCE against the queue for both positives (builder :77).

    With bf16 heads the dtypes follow JAX's promotions: the positive logits
    are bf16 sums, ``q_a @ queue`` promotes to the queue's f32 (torch's
    matmul takes one dtype, so the cast is explicit), and the logits and
    the cross-entropy are f32."""
    l_pos_a1 = torch.sum(q_a * k_a, dim=1, keepdim=True)
    l_pos_a2 = torch.sum(q_a * k_neg_a, dim=1, keepdim=True)
    dt = torch.promote_types(q_a.dtype, queue.dtype)
    l_neg_a = q_a.to(dt) @ queue.detach().to(dt)
    logits1 = torch.cat([l_pos_a1.to(dt), l_neg_a], dim=1) / cfg.t
    logits2 = torch.cat([l_pos_a2.to(dt), l_neg_a], dim=1) / cfg.t
    labels = torch.zeros(q_a.shape[0], dtype=torch.long, device=q_a.device)
    loss = F.cross_entropy(logits1, labels) + F.cross_entropy(logits2, labels)
    return loss, (logits1, logits2)


def avid_metrics_dense(aux, cfg: MoCoConfig) -> Dict[str, torch.Tensor]:
    """Top-1/5 of the positive in both dense logit rows (builder.py:87)."""
    logits1, logits2 = aux
    labels = torch.zeros(logits1.shape[0], dtype=torch.long,
                         device=logits1.device)
    acc1_a, acc5_a = accuracy(logits1, labels, topk=(1, 5))
    acc1_an, acc5_an = accuracy(logits2, labels, topk=(1, 5))
    return {"acc1_A": acc1_a, "acc5_A": acc5_a, "acc1_A_n": acc1_an,
            "acc5_A_n": acc5_an}


@torch.no_grad()
def queue_update(queue: torch.Tensor, queue_ptr: int,
                 keys: torch.Tensor) -> int:
    """Ring enqueue of keys [B, dim] in place; returns the new pointer."""
    batch = keys.shape[0]
    if queue.shape[1] % batch != 0:
        # a partial slice would overwrite live columns while the pointer
        # advances modulo K (builder :46-54)
        raise ValueError(
            f"moco.k ({queue.shape[1]}) must be divisible by the global "
            f"batch ({batch}); see utils/moco.py:replace_moco_k_in_config")
    queue[:, queue_ptr:queue_ptr + batch] = keys.T.to(queue.dtype)
    return (queue_ptr + batch) % queue.shape[1]


@dataclass(frozen=True)
class StepLayout:
    """The collectives a layout injects into the step body
    (step_core.py:240-265):

    avid_loss(q_a, k_a, k_neg_a, queue, cfg) -> (loss_a, aux): the A-VID
        cross entropy summed over both positives;
    avid_metrics(aux, cfg) -> acc{1,5}_A, acc{1,5}_A_n;
    loss_scale: multiplies the differentiated loss (1/M in 2-D);
    grad_combine(parameters): the gradient mean over the mesh;
    gather_keys(k_neg_a): the local keys -> the global batch of keys;
    queue_update(queue, ptr, keys) -> ptr: the ring enqueue;
    metrics_combine(metrics): the metric mean over the mesh.
    """
    avid_loss: Callable = avid_loss_dense
    avid_metrics: Callable = avid_metrics_dense
    loss_scale: float = 1.0
    grad_combine: Callable = lambda params: None
    gather_keys: Callable = lambda keys: keys
    queue_update: Callable = queue_update
    metrics_combine: Callable = lambda metrics: metrics


def moco_objective(q_a, q_m, k_a, k_m, k_neg_a, k_neg_m, queue,
                   cfg: MoCoConfig, layout: Optional[StepLayout] = None):
    """The A-VID + margin-ranking loss and the step's metrics
    (step_core.py:332-370). The RSP logits and their loss stay in the heads'
    dtype (bf16 sums, as in JAX); the total loss is the promotion of both
    terms. Metrics are 0-d tensors in the loss's dtype (percent for
    accuracies), this rank's (``layout.metrics_combine`` averages them)."""
    layout = layout or SINGLE
    loss_a, aux = layout.avid_loss(q_a, k_a, k_neg_a, queue, cfg)
    # JAX applies a Python constant to a bf16 array as a bf16 value (a weak
    # type): t, the margin and lambda_M are rounded to the heads' dtype
    t, margin, lambda_m = (q_m.new_full((), v) for v in
                           (cfg.t, cfg.margin, cfg.loss_lambda_m))
    l_pos_m = torch.sum(q_m * k_m, dim=1, keepdim=True) / t
    l_neg_m = torch.sum(q_m * k_neg_m, dim=1, keepdim=True) / t
    loss_m = torch.clamp(margin - (l_pos_m - l_neg_m), min=0.0).mean()
    loss = cfg.loss_lambda_a * loss_a + lambda_m * loss_m
    with torch.no_grad():
        acc_m = (l_pos_m > l_neg_m).to(loss.dtype).mean() * 100.0
        metrics = {"loss": loss, "loss_A": loss_a, "loss_M": loss_m,
                   **layout.avid_metrics(aux, cfg), "acc1_M": acc_m}
        metrics = {k: v.detach().to(loss.dtype) for k, v in metrics.items()}
    return loss, metrics


# one process: no collective
SINGLE = StepLayout()


def _metrics_mean(group):
    def combine(metrics):
        keys = list(metrics)
        row = all_reduce_mean(torch.stack([metrics[k] for k in keys]), group)
        return dict(zip(keys, row.unbind()))
    return combine


def data_parallel_layout(group) -> StepLayout:
    """The 1-D data-parallel collectives over ``group`` (builder.py:103):
    the gradient and metric means, the keys gathered in rank order (F3:
    the global batch of keys, so K must divide by it). A group of one rank
    still takes each collective."""
    n = torch.distributed.get_world_size(group)
    return StepLayout(
        grad_combine=lambda params: combine_grads(params, group, n),
        gather_keys=lambda keys: all_gather_rows(keys, group),
        metrics_combine=_metrics_mean(group))


def train_step(state: MoCoState, im_q: torch.Tensor, im_k: torch.Tensor,
               cfg: MoCoConfig, *, generator: Optional[torch.Generator] = None,
               perm: Optional[torch.Tensor] = None,
               speed_index: Optional[int] = None,
               layout: Optional[StepLayout] = None
               ) -> Dict[str, torch.Tensor]:
    """One step on NDHWC clips [B, T, H, W, 3] (this rank's rows of the
    global batch under a layout); updates ``state`` in place and returns
    the metrics (``moco_objective``), averaged over the mesh."""
    layout = layout or SINGLE
    model_q, model_k = state.model_q, state.model_k
    model_q.train()
    model_k.train()

    # 1. momentum update BEFORE key encoding (reference :507-509)
    with tracing.phase("rsp.step.ema"):
        momentum_update(model_q, model_k, cfg.m)

    # 2. dual-speed sampling
    with tracing.phase("rsp.step.gather"):
        q_real, k_real, k_neg = diff_speed_gather(
            im_q, im_k, cfg, perm=perm, speed_index=speed_index,
            generator=generator)

    # 3. fused 2B key pass, no grad
    with tracing.phase("rsp.step.key_pass"):
        k_a, k_m, k_neg_a, k_neg_m = key_pass(model_k, k_real, k_neg)

    # 4. query pass + loss
    with tracing.phase("rsp.step.q_forward"):
        q_a, q_m = model_q(q_real)
        loss, metrics = moco_objective(q_a, q_m, k_a, k_m, k_neg_a, k_neg_m,
                                       state.queue, cfg, layout)

    # 5. backward (zero_grad to None launches nothing), the mesh-wide
    #    gradient combine, SGD
    with tracing.phase("rsp.step.backward"):
        state.optimizer.zero_grad(set_to_none=True)
        if layout.loss_scale != 1.0:
            loss = loss * layout.loss_scale
        loss.backward()
    with tracing.phase("rsp.step.optimizer"):
        layout.grad_combine(model_q.parameters())
        state.optimizer.step()

    # 6. enqueue the global batch of negative keys (reference enqueues
    #    k_neg_A, :544)
    with tracing.phase("rsp.step.enqueue"):
        state.queue_ptr = layout.queue_update(state.queue, state.queue_ptr,
                                              layout.gather_keys(k_neg_a))
    state.step += 1
    return layout.metrics_combine(metrics)


@torch.no_grad()
def eval_step(state: MoCoState, im_q: torch.Tensor, im_k: torch.Tensor,
              cfg: MoCoConfig, *, perm: Optional[torch.Tensor] = None,
              speed_index: Optional[int] = None,
              generator: Optional[torch.Generator] = None,
              layout: Optional[StepLayout] = None
              ) -> Dict[str, torch.Tensor]:
    """The train step's metrics without training (``--validate``; port of
    step_core.py:383 make_eval_body). Both encoders run in eval mode (BN
    from its running statistics), the keys in one fused 2B forward. Nothing
    is updated: no EMA, no BN statistics, no enqueue, no optimizer step.
    The encoders' train/eval modes are restored afterwards."""
    model_q, model_k = state.model_q, state.model_k
    modes = (model_q.training, model_k.training)
    model_q.eval()
    model_k.eval()
    try:
        q_real, k_real, k_neg = diff_speed_gather(
            im_q, im_k, cfg, perm=perm, speed_index=speed_index,
            generator=generator)
        b = k_real.shape[0]
        k2_a, k2_m = model_k(torch.cat([k_real, k_neg], dim=0))
        q_a, q_m = model_q(q_real)
        layout = layout or SINGLE
        _, metrics = moco_objective(q_a, q_m, k2_a[:b], k2_m[:b], k2_a[b:],
                                    k2_m[b:], state.queue, cfg, layout)
        return layout.metrics_combine(metrics)
    finally:
        model_q.train(modes[0])
        model_k.train(modes[1])
