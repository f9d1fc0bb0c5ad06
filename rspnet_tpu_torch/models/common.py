"""Shared building blocks for the port's backbones (torch, NCDHW views).

Port of rspnet_tpu/models/common.py. Activations are NCDHW tensors in
``torch.channels_last_3d`` memory, which is NDHWC physically, so the pool
kernel's NDHWC view is a free ``permute``.

Compute dtype, as flax's ``dtype`` attribute: ``None`` computes in the
input's dtype; ``torch.bfloat16`` keeps the parameters and BN statistics in
f32 and casts each conv's input and weight to bf16, as the JAX package does
on its accelerator.
"""
from __future__ import annotations

from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import max_pool3d as _pool
from ..parallel.collectives import (all_gather_rows, all_reduce_mean,
                                    all_reduce_sum)

IntOr3 = Union[int, Tuple[int, int, int]]


def _triple(x: IntOr3) -> Tuple[int, int, int]:
    if isinstance(x, int):
        return (x, x, x)
    return tuple(x)


class BatchNorm(nn.BatchNorm3d):
    """torch BatchNorm3d with the JAX package's hyper-parameters.

    rspnet_tpu/models/common.py:BatchNorm (:36) normalizes with the biased
    batch variance and updates ``running_var`` with the unbiased one, which
    is what BatchNorm3d does. Its flax momentum m becomes torch 1 - m.
    The statistics are taken in (at least) f32 whatever the input's dtype,
    and the output is cast to ``dtype`` (or stays in the input's), as there
    (:79-80, :106).

    Cross-replica moments (``process_group``, set by
    ``set_bn_process_group``; the shuffle-BN replacement, :89-92): in
    training over a group, the batch moments are those of every rank's
    batch, and the running variance takes the Bessel factor of n x world
    elements, as the JAX module's ``axis_name`` does. On a CPU tensor E[x]
    and E[x^2] are averaged over the group with one ``all_reduce`` of [2C]
    values and the variance is E[x^2] - E[x]^2, the JAX module's formula.
    On a CUDA tensor ``_SyncBatchNorm`` takes them with torch's CUDA
    batch-norm kernels, those of ``nn.SyncBatchNorm``'s function: a
    bf16 input is read in place with f32 statistics, where the CPU formula
    keeps f32 copies of it for autograd. ``convert_sync_batchnorm`` is not
    used: it would replace this class (its f32 statistics and output cast),
    and its function gathers with ``all_gather``, which gloo lacks for
    CUDA tensors. The engines set a group only when more than one rank
    runs.
    """

    def __init__(self, num_features: int, flax_momentum: float = 0.9,
                 eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__(num_features, eps=eps, momentum=1.0 - flax_momentum)
        self.dtype = dtype
        self.process_group = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training and self.process_group is not None:
            y = self._cross_replica(x, self.process_group)
        else:
            y = super().forward(x)
        return y.to(self.dtype or x.dtype)

    def _cross_replica(self, x: torch.Tensor, group) -> torch.Tensor:
        with torch.no_grad():
            self.num_batches_tracked.add_(1)
        momentum = (1.0 / float(self.num_batches_tracked)
                    if self.momentum is None else self.momentum)
        if x.is_cuda:
            return _SyncBatchNorm.apply(x, self.weight, self.bias,
                                        self.running_mean, self.running_var,
                                        self.eps, momentum, group)
        c = x.shape[1]
        xf = x.to(torch.promote_types(torch.float32, x.dtype))
        dims = [0] + list(range(2, x.dim()))
        moments = all_reduce_mean(
            torch.cat([xf.mean(dims), (xf * xf).mean(dims)]), group)
        mean, mean2 = moments[:c], moments[c:]
        var = torch.clamp(mean2 - mean * mean, min=0.0)
        shape = (1, c) + (1,) * (x.dim() - 2)
        with torch.no_grad():
            n = x.numel() // c * torch.distributed.get_world_size(group)
            self.running_mean.mul_(1 - momentum).add_(
                momentum * mean.detach().to(self.running_mean.dtype))
            self.running_var.mul_(1 - momentum).add_(
                momentum * (var.detach() * (n / max(n - 1, 1))).to(
                    self.running_var.dtype))
        y = (xf - mean.view(shape)) * torch.rsqrt(var + self.eps).view(shape)
        return (y * self.weight.to(y.dtype).view(shape)
                + self.bias.to(y.dtype).view(shape))


def _memory_format(x: torch.Tensor) -> torch.memory_format:
    return (torch.channels_last_3d
            if x.is_contiguous(memory_format=torch.channels_last_3d)
            else torch.contiguous_format)


class _SyncBatchNorm(torch.autograd.Function):
    """Cross-replica BN on CUDA tensors: torch.nn.modules._functions
    .SyncBatchNorm with its ``all_gather`` of each rank's (mean, invstd,
    count) taken as ``all_gather_rows`` (an ``all_reduce``, which gloo has
    for CUDA tensors). The statistics are the input's accumulation type
    (f32 for bf16); the output is in the input's dtype. The weight and
    bias gradients stay this rank's: the step's gradient mean combines
    them."""

    @staticmethod
    def forward(ctx, x, weight, bias, running_mean, running_var, eps,
                momentum, group):
        x = x.contiguous(memory_format=_memory_format(x))
        c = x.shape[1]
        mean, invstd = torch.batch_norm_stats(x, eps)
        count = mean.new_full((1,), x.numel() // c)
        every = all_gather_rows(torch.cat([mean, invstd, count])[None],
                                group)
        counts = every[:, 2 * c]
        mean, invstd = torch.batch_norm_gather_stats_with_counts(
            x, every[:, :c], every[:, c:2 * c], running_mean, running_var,
            momentum, eps, counts.to(running_mean.dtype))
        ctx.save_for_backward(x, weight, mean, invstd,
                              counts.to(torch.int32))
        ctx.group = group
        return torch.batch_norm_elemt(x, weight, bias, mean, invstd, eps)

    @staticmethod
    def backward(ctx, grad):
        x, weight, mean, invstd, counts = ctx.saved_tensors
        grad = grad.contiguous(memory_format=_memory_format(x))
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        sum_dy, sum_dy_xmu, grad_w, grad_b = torch.batch_norm_backward_reduce(
            grad, x, mean, invstd, weight, need_x, need_w, need_b)
        grad_x = None
        if need_x:
            c = sum_dy.shape[0]
            sums = all_reduce_sum(torch.cat([sum_dy, sum_dy_xmu]), ctx.group)
            grad_x = torch.batch_norm_backward_elemt(
                grad, x, mean, invstd, weight, sums[:c], sums[c:], counts)
        return (grad_x, grad_w if need_w else None,
                grad_b if need_b else None, None, None, None, None, None)


def set_bn_process_group(model: nn.Module, group) -> None:
    """Every ``BatchNorm`` of ``model`` takes its training moments over
    ``group`` (None: this process alone). ``SubBatchNorm`` stays
    per-replica, as in the JAX package."""
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.process_group = group


def conv3d(conv: nn.Conv3d, x: torch.Tensor,
           dtype: Optional[torch.dtype]) -> torch.Tensor:
    """``conv`` as flax's ``nn.Conv(dtype=...)`` computes it: input, weight
    and bias cast to ``dtype`` (the input's dtype if None), the bias added
    to the rounded convolution. The output keeps a channels-last input's
    memory format (cuDNN keeps it; the CPU's one-thread 1^3 convolution
    returns NCDHW, which would put a copy before the next pool)."""
    dt = dtype or x.dtype
    y = F.conv3d(x.to(dt), conv.weight.to(dt), None, conv.stride,
                 conv.padding, groups=conv.groups)
    if x.is_contiguous(memory_format=torch.channels_last_3d):
        y = y.contiguous(memory_format=torch.channels_last_3d)
    if conv.bias is not None:
        y = y + conv.bias.to(dt).view(-1, 1, 1, 1)
    return y


def dense(x: torch.Tensor, linear: nn.Linear,
          dtype: Optional[torch.dtype]) -> torch.Tensor:
    """flax ``nn.Dense(dtype=...)``: input, weight and bias cast to
    ``dtype`` (the input's if None), the bias added to the rounded
    product."""
    dt = dtype or x.dtype
    return F.linear(x.to(dt), linear.weight.to(dt)) + linear.bias.to(dt)


def make_conv(in_channels: int, out_channels: int, kernel_size: IntOr3,
              stride: IntOr3 = 1, padding: IntOr3 = 0,
              use_bias: bool = False) -> nn.Conv3d:
    """Conv3d with the JAX package's kernel init (kaiming normal, fan_out,
    rspnet_tpu/models/common.py:195) and flax's zero bias."""
    conv = nn.Conv3d(in_channels, out_channels, _triple(kernel_size),
                     _triple(stride), _triple(padding), bias=use_bias)
    nn.init.kaiming_normal_(conv.weight, mode="fan_out", nonlinearity="relu")
    if use_bias:
        nn.init.zeros_(conv.bias)
    return conv


def conv_bn(conv: nn.Conv3d, bn: "BatchNorm", x: torch.Tensor,
            dtype: Optional[torch.dtype], activation: bool = True
            ) -> torch.Tensor:
    """The JAX package's ``ConvBN`` (rspnet_tpu/models/common.py:176): conv
    (with its bias, if it has one), BN, and a ReLU unless ``activation`` is
    False (a residual block's last conv). The modules are passed in, so a
    backbone can register them under the reference's sibling names
    (``conv1`` and ``bn1``), which a ``ConvBN`` child cannot give."""
    y = bn(conv3d(conv, x, dtype))
    return torch.relu(y) if activation else y


class ConvBN(nn.Module):
    """Conv3d (no bias) + BatchNorm + ReLU, named like the reference's
    BasicConv3d (``conv3d``, ``bn``) (rspnet_tpu/models/common.py:176)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr3, stride: IntOr3 = 1,
                 padding: IntOr3 = 0, bn_momentum: float = 0.9,
                 bn_eps: float = 1e-5, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv3d = make_conv(in_channels, out_channels, kernel_size,
                                stride, padding)
        self.bn = BatchNorm(out_channels, bn_momentum, bn_eps, dtype)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_bn(self.conv3d, self.bn, x, self.dtype)


class SubBatchNorm(nn.Module):
    """Split-batch normalization (rspnet_tpu/models/common.py:SubBatchNorm,
    :109), NCDHW.

    In training the statistics are taken over each of ``num_splits``
    interleaved subsets of the batch (sample i in split ``i % num_splits``,
    the reshape to ``[n // k, k, ...]``), with the biased variance, and one
    affine pair is shared. ``running_mean`` and ``running_var`` are
    ``[k, C]``; ``running_var`` is updated with each split's unbiased
    variance. In eval mode the statistics are aggregated on the fly: the
    mean of the split means, and the mean of the split variances plus the
    variance between the split means. A batch that ``k`` does not divide
    raises. The statistics are taken in (at least) f32, as the port's
    ``BatchNorm`` does; the JAX module casts to f32 even under x64, so the
    two agree in f32 and bf16. The output is cast to ``dtype`` (or stays in
    the input's).
    """

    def __init__(self, num_features: int, num_splits: int,
                 flax_momentum: float = 0.9, eps: float = 1e-5,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.num_splits, self.momentum, self.eps = num_splits, flax_momentum, eps
        self.dtype = dtype
        self.weight = nn.Parameter(torch.ones(num_features))
        self.bias = nn.Parameter(torch.zeros(num_features))
        self.register_buffer("running_mean",
                             torch.zeros(num_splits, num_features))
        self.register_buffer("running_var",
                             torch.ones(num_splits, num_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k, n, c = self.num_splits, x.shape[0], x.shape[1]
        xf = x.to(torch.promote_types(x.dtype, torch.float32))
        if self.training:
            if n % k:
                raise ValueError(f"SubBatchNorm: batch {n} not divisible "
                                 f"by num_splits {k}")
            xs = xf.reshape(n // k, k, *x.shape[1:])
            dims = (0, 3, 4, 5)
            m = xs.mean(dims)                                   # [k, C]
            d = xs - m.view(1, k, c, 1, 1, 1)
            v = (d * d).mean(dims)
            n_el = xs.numel() // (k * c)
            unbias = n_el / max(n_el - 1, 1)
            with torch.no_grad():
                rm, rv = self.running_mean, self.running_var
                rm.copy_(self.momentum * rm + (1 - self.momentum) * m)
                rv.copy_(self.momentum * rv
                         + (1 - self.momentum) * v * unbias)
            y = (d * torch.rsqrt(v + self.eps).view(1, k, c, 1, 1, 1)
                 ).reshape(x.shape)
        else:
            rm = self.running_mean.to(xf.dtype)
            m = rm.mean(0)
            v = (self.running_var.to(xf.dtype).mean(0)
                 + ((rm - m) ** 2).mean(0))
            y = (xf - m.view(1, c, 1, 1, 1)) * torch.rsqrt(
                v + self.eps).view(1, c, 1, 1, 1)
        y = (y * self.weight.to(y.dtype).view(1, c, 1, 1, 1)
             + self.bias.to(y.dtype).view(1, c, 1, 1, 1))
        return y.to(self.dtype or x.dtype)


def make_norm(num_features: int, bn_splits: int = 1,
              dtype: Optional[torch.dtype] = None) -> nn.Module:
    """``BatchNorm``, or ``SubBatchNorm`` when ``bn_splits > 1`` (the JAX
    ``ConvBN``'s choice, rspnet_tpu/models/common.py:212)."""
    if bn_splits > 1:
        return SubBatchNorm(num_features, bn_splits, dtype=dtype)
    return BatchNorm(num_features, dtype=dtype)


class ConvNorm(nn.Module):
    """The JAX package's ``ConvBN`` under its own child names (``conv``,
    ``bn``), for backbones and heads whose module names follow the JAX
    tree: a conv (with a bias if ``use_bias``), an optional BN
    (``SubBatchNorm`` when ``bn_splits > 1``; its scale starts at zero if
    ``zero_bn``) and a ReLU unless ``activation`` is False
    (rspnet_tpu/models/common.py:176)."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: IntOr3, stride: IntOr3 = 1,
                 padding: IntOr3 = 0, use_bias: bool = False,
                 use_bn: bool = True, activation: bool = True,
                 bn_splits: int = 1, zero_bn: bool = False,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = make_conv(in_channels, out_channels, kernel_size, stride,
                              padding, use_bias)
        self.bn = (make_norm(out_channels, bn_splits, dtype) if use_bn
                   else None)
        if zero_bn:
            nn.init.zeros_(self.bn.weight)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = conv3d(self.conv, x, self.dtype)
        if self.bn is not None:
            y = self.bn(y)
        return torch.relu(y) if self.activation else y


def max_pool3d(x: torch.Tensor, kernel, strides, padding=0) -> torch.Tensor:
    """torch MaxPool3d semantics (floor mode, -inf padding) on an NCDHW
    tensor, through kernels K1/K2 (rspnet_tpu/models/common.py:476), in the
    tensor's own dtype (f32 or bf16 on the card)."""
    ndhwc = x.permute(0, 2, 3, 4, 1).contiguous()
    out = _pool.max_pool3d(ndhwc, kernel, strides, padding)
    return out.permute(0, 4, 1, 2, 3)


def avg_pool3d(x: torch.Tensor, kernel, strides, padding=0) -> torch.Tensor:
    """torch AvgPool3d semantics (count_include_pad=True) on an NCDHW
    tensor (rspnet_tpu/models/common.py:531): the window sum over zero
    padding, in the tensor's dtype, divided by the window size. Plain
    torch, which takes bf16 on the CPU too; ResNet's type-A shortcut (k 1)
    is an exact strided subsample."""
    k, s, p = _triple(kernel), _triple(strides), _triple(padding)
    x = F.pad(x, (p[2], p[2], p[1], p[1], p[0], p[0]))
    n = [(d - kk) // ss + 1 for d, kk, ss in zip(x.shape[2:], k, s)]
    acc = None
    for dt in range(k[0]):
        for dh in range(k[1]):
            for dw in range(k[2]):
                v = x[:, :, dt:dt + (n[0] - 1) * s[0] + 1:s[0],
                      dh:dh + (n[1] - 1) * s[1] + 1:s[1],
                      dw:dw + (n[2] - 1) * s[2] + 1:s[2]]
                acc = v if acc is None else acc + v
    return acc / (k[0] * k[1] * k[2])


class MaxPool3d(nn.Module):
    def __init__(self, kernel, strides, padding=0):
        super().__init__()
        self.geom = (_triple(kernel), _triple(strides), _triple(padding))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return max_pool3d(x, *self.geom)


def softmax_last(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softmax`` over the last axis in x's dtype: the shifted
    exponent, its sum (in at least f32, rounded once to x's dtype, as XLA
    sums) and the quotient, each rounded to the dtype."""
    e = torch.exp(x - x.detach().amax(dim=-1, keepdim=True))
    acc = torch.promote_types(x.dtype, torch.float32)
    return e / e.to(acc).sum(dim=-1, keepdim=True).to(x.dtype)


def mean_dim(x: torch.Tensor, dim=None) -> torch.Tensor:
    """``jnp.mean`` over ``dim`` (all of x if None): summed and divided in
    (at least) f32, rounded once to x's dtype."""
    return x.to(torch.promote_types(x.dtype, torch.float32)).mean(dim).to(
        x.dtype)


def global_avg_pool(x: torch.Tensor) -> torch.Tensor:
    """AdaptiveAvgPool3d(1) + flatten: [B, C, T, H, W] -> [B, C]; a bf16
    input is summed in f32 and rounded once, as ``jnp.mean`` does."""
    return x.mean(dim=(2, 3, 4))
