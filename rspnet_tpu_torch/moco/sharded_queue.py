"""2-D ``data x model`` MoCo: the negative queue sharded along K (port of
rspnet_tpu/moco/sharded_queue.py).

The mesh is ``(data=D, model=M)`` ranks; the batch is sharded over both
axes (each rank holds B rows of the D*M*B global batch) and the queue
``[dim, K]`` over the model axis: rank ``d * M + m`` holds columns
``[m K/M, (m + 1) K/M)``.

- The contrastive row of a query spans K + 1 columns, so its softmax is
  distributed: the model group gathers its queries (a differentiable
  gather whose backward sums the group's cotangents, the transpose
  ``shard_map`` gives ``all_gather``), each rank contracts them with its
  shard, and the cross entropy takes a logsumexp summed over the model
  group. Top-1/5 become rank counts (negatives strictly above the
  positive, summed over the group), which ``accuracy`` on the full row
  equals (ties favour the positive in both).
- The enqueue lands on one shard a step (``K/M % global batch == 0``),
  written where the global pointer falls.
- Gradient combine: each rank backpropagates the group loss through its
  rows, so the group's gradient is the sum over the model group; the
  global one the mean over data groups. The whole loss is scaled by 1/M
  first (a group-identical term arrives M-fold), and both reductions are
  one ``all_reduce`` over the world divided by D.

Checkpoints hold the dense queue (``gather_queue_2d``), so both packages
read them and a 2-D run resumes from a dense one (``shard_queue_2d``).
"""
from __future__ import annotations

import torch

from ..parallel import (Mesh, all_gather_rows, all_reduce_sum,
                        combine_grads)
from .step import (SINGLE, MoCoConfig, StepLayout, _metrics_mean,
                   data_parallel_layout)


def sharded_ce_and_rank(l_pos, l_neg_part, group):
    """CE(label 0) and the positive's rank over model-sharded negatives
    (sharded_queue.py:55). l_pos: [B_g, 1] the group's positive logits;
    l_neg_part: [B_g, K/M] this rank's shard of the negative logits (both
    already / t). Returns (the mean CE over the group's rows, [B_g] the
    number of negatives strictly above the positive), the same on every
    rank of the group."""
    with torch.no_grad():
        shard_max = l_neg_part.amax(dim=1)                         # [B_g]
        gmax = all_gather_rows(shard_max[None], group).amax(dim=0)
        zmax = torch.maximum(l_pos, gmax[:, None].to(l_pos.dtype))
    sumexp = torch.exp(l_pos - zmax) + all_reduce_sum(
        torch.sum(torch.exp(l_neg_part - zmax), dim=1, keepdim=True), group)
    ce = torch.mean(torch.log(sumexp)[:, 0] + zmax[:, 0] - l_pos[:, 0])
    with torch.no_grad():
        rank = all_reduce_sum((l_neg_part > l_pos).sum(dim=1), group)
    return ce, rank


@torch.no_grad()
def queue_update_sharded(queue_shard: torch.Tensor, queue_ptr: int,
                         keys: torch.Tensor, model_index: int,
                         n_model: int) -> int:
    """Ring enqueue into this rank's K-shard [dim, K/M] (sharded_queue.py:
    80); ``keys`` [global B, dim] are gathered over both axes. The pointer
    advances modulo K on every rank; only the shard that holds it
    writes."""
    k_shard = queue_shard.shape[1]
    batch = keys.shape[0]
    if k_shard % batch != 0:
        # a batch that straddles two shards would need a cross-rank write
        raise ValueError(
            f"sharded queue: K/M ({k_shard}) must be divisible by the "
            f"global batch ({batch}) so each enqueue lands inside one "
            f"shard; adjust moco.k or the model-axis size")
    local = queue_ptr - model_index * k_shard
    if 0 <= local < k_shard:
        queue_shard[:, local:local + batch] = keys.T.to(queue_shard.dtype)
    return (queue_ptr + batch) % (k_shard * n_model)


def data_model_layout(mesh: Mesh) -> StepLayout:
    """The 2-D collectives (sharded_queue.py:111): the distributed softmax
    over the queue shards, rank-count accuracies, the 1/M loss scale,
    sum(model) then mean(data) of the gradients, the keys of every rank,
    the predicated enqueue, the metric mean over the mesh."""
    mg = mesh.model_group

    def avid_loss(q_a, k_a, k_neg_a, queue, cfg: MoCoConfig):
        # the positive logits in the promoted dtype, as the dense path's
        # (the JAX 2-D path divides them in the heads' dtype)
        dt = torch.promote_types(q_a.dtype, queue.dtype)
        l_pos_a1 = torch.sum(q_a * k_a, dim=1, keepdim=True).to(dt) / cfg.t
        l_pos_a2 = (torch.sum(q_a * k_neg_a, dim=1, keepdim=True).to(dt)
                    / cfg.t)
        q_grp = all_gather_rows(q_a, mg)
        l_neg_part = (q_grp.to(dt) @ queue.detach().to(dt)) / cfg.t
        ce1, rank1 = sharded_ce_and_rank(all_gather_rows(l_pos_a1, mg),
                                         l_neg_part, mg)
        ce2, rank2 = sharded_ce_and_rank(all_gather_rows(l_pos_a2, mg),
                                         l_neg_part, mg)
        return ce1 + ce2, (rank1, rank2)

    def avid_metrics(aux, cfg: MoCoConfig):
        rank1, rank2 = aux
        top5 = min(5, int(cfg.k) + 1)   # accuracy()'s maxk clamp

        def acc(r, n):
            return (r < n).to(torch.float32).mean() * 100.0
        return {"acc1_A": acc(rank1, 1), "acc5_A": acc(rank1, top5),
                "acc1_A_n": acc(rank2, 1), "acc5_A_n": acc(rank2, top5)}

    return StepLayout(
        avid_loss=avid_loss,
        avid_metrics=avid_metrics,
        loss_scale=1.0 / mesh.model,
        grad_combine=lambda params: combine_grads(params, mesh.group,
                                                  mesh.data),
        gather_keys=lambda keys: all_gather_rows(keys, mesh.group),
        queue_update=lambda queue, ptr, keys: queue_update_sharded(
            queue, ptr, keys, mesh.model_index, mesh.model),
        metrics_combine=_metrics_mean(mesh.group))


def shard_queue_2d(queue: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """This rank's K-shard of a dense queue [dim, K] (every rank holds the
    same dense queue; sharded_queue.py:275)."""
    k_shard = queue.shape[1] // mesh.model
    m = mesh.model_index
    return queue[:, m * k_shard:(m + 1) * k_shard].clone()


def gather_queue_2d(queue_shard: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The dense queue [dim, K] from the model group's shards, on every
    rank (the checkpoint layout, sharded_queue.py:294)."""
    return all_gather_rows(queue_shard.T.contiguous(), mesh.model_group).T


def layout_for(mesh: Mesh) -> StepLayout:
    """The step layout of a mesh: none without a group, 1-D, or 2-D."""
    if mesh.group is None:
        return SINGLE
    if mesh.is_2d:
        return data_model_layout(mesh)
    return data_parallel_layout(mesh.group)


__all__ = ["data_model_layout", "gather_queue_2d", "layout_for",
           "queue_update_sharded", "shard_queue_2d", "sharded_ce_and_rank"]
