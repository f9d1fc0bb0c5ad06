"""The collectives the steps take, each an ``all_reduce``.

Every collective here is a sum over a group: gloo provides ``all_reduce``
(and ``broadcast``) for CUDA tensors where it lacks ``all_gather``, so one
form serves NCCL, gloo on the CPU and gloo on a card that two ranks share.
A gather is the sum of zero-padded rows, one block a rank, which is exact:
each element is one rank's value plus zeros.

``all_reduce_sum`` and ``all_gather_rows`` are differentiable with the
transposes that ``shard_map`` gives their JAX counterparts: a ``psum``'s
cotangent is summed over the group, and an ``all_gather``'s rows take the
group's summed cotangent (a reduce-scatter). Under ``no_grad``, or on a
tensor that needs no gradient, they are plain collectives.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


# the all-reduces this process made and the bytes they summed, counted
# where each is called, as the kernels count their launches
all_reduces = {"calls": 0, "bytes": 0}


def _sum_(x: torch.Tensor, group) -> torch.Tensor:
    all_reduces["calls"] += 1
    all_reduces["bytes"] += x.numel() * x.element_size()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """[B, ...] -> [n * B, ...], rank r's rows at [r * B, (r + 1) * B).
    Floating types narrower than f32 are summed in f32 (exact: one value
    and zeros) and come back in their own type."""
    n, r = dist.get_world_size(group), dist.get_rank(group)
    wide = (torch.promote_types(x.dtype, torch.float32)
            if x.is_floating_point() else x.dtype)
    buf = x.new_zeros((n,) + tuple(x.shape), dtype=wide)
    buf[r] = x
    return _sum_(buf, group).reshape((n * x.shape[0],)
                                     + tuple(x.shape[1:])).to(x.dtype)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum_(x.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return _sum_(g.contiguous().clone(), ctx.group), None


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rows = x.shape[0]
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        r, b = dist.get_rank(ctx.group), ctx.rows
        g = _sum_(g.contiguous().clone(), ctx.group)
        return g[r * b:(r + 1) * b], None


def _differentiable(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over ``group`` (a new tensor)."""
    if _differentiable(x):
        return _AllReduceSum.apply(x, group)
    return _sum_(x.detach().clone(), group)


def all_reduce_mean(x: torch.Tensor, group) -> torch.Tensor:
    return all_reduce_sum(x, group) / dist.get_world_size(group)


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` of every rank of ``group`` along dim 0, in rank order (every
    rank passes the same shape)."""
    if _differentiable(x):
        return _AllGatherRows.apply(x, group)
    return _gather(x.detach(), group)


def combine_grads(params, group, divisor: int) -> None:
    """Sum the gradients of ``params`` over ``group`` in one flat buffer
    and divide by ``divisor`` (the data-parallel mean: the world size). A
    parameter without a gradient on this rank has none on any: every rank
    runs the same graph."""
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return
    flat = _sum_(torch.cat([g.reshape(-1) for g in grads]), group)
    flat.div_(divisor)
    offset = 0
    for g in grads:
        g.copy_(flat[offset:offset + g.numel()].view_as(g))
        offset += g.numel()


def broadcast_(x: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``x`` on every rank, in place."""
    dist.broadcast(x, src=src, group=group)
    return x
