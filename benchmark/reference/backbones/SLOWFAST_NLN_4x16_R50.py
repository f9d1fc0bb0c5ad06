"""Plain float32 SlowFast-NLN R50 4x16 (Feichtenhofer et al. 2019,
"SlowFast Networks for Video Recognition", arXiv:1812.03982), with the
non-local blocks of Wang et al. 2018 ("Non-local Neural Networks",
arXiv:1711.07971), as facebookresearch/SlowFast's
``configs/Kinetics/SLOWFAST_NLN_4x16_R50.yaml`` fixes it: alpha 8, beta
1/8, fusion channel ratio 2, fusion kernel 5, depth 50, ``dot_product``
non-local blocks after res3 blocks 1 and 3 and res4 blocks 1, 3 and 5 of
the slow pathway.

A clip of T frames feeds two pathways:

- the fast pathway takes all T frames at 1/8 of the channels: a (5,7,7)
  stem to 8 channels, stride (1,2,2), then bottleneck stages of 3, 4, 6
  and 3 blocks with inner widths 8, 16, 32, 64 (outputs 4x), a (3,1,1)
  temporal kernel in every block;
- the slow pathway takes T / 8 frames, those at ``linspace(0, T - 1,
  T / 8)`` rounded down (the frames 0, 10, 20, 31 of 32): a (1,7,7) stem
  to 64 channels, then the same stages at inner widths 64 to 512 (outputs
  256 to 2048), a temporal kernel of 3 in res4 and res5 only.

Each stem is conv, BN, ReLU and a (1,3,3) max pool of stride (1,2,2) and
padding (0,1,1). A bottleneck is (tk,1,1) -> (1,3,3) -> 1^3 convolutions,
each with BN and the first two with a ReLU, the spatial stride 2 of res3
to res5 on the (1,3,3) one, a 1^3 projection with BN where the shape
changes, and a ReLU after the residual sum. Before the slow stem's output
and each of the slow res2 to res4 outputs goes on, a lateral connection
takes the fast map at the same depth through a (5,1,1) convolution of
temporal stride 8 (padding 2) to twice its channels, BN and ReLU, and
concatenates it after the slow channels. A non-local block takes theta
from its input and phi and g from the input max-pooled (1,2,2) / (1,2,2),
each a biased 1^3 convolution to half the channels; the attention is
theta phi^T over the number of keys (no softmax), applied to g; a biased
1^3 convolution back to the block's width and a BN follow, added to the
input. ``features`` returns the slow map, then the fast map with its T
averaged down to the slow grid, concatenated: 2048 + 256 = 2304 channels,
whose global average is what both heads read.

Departures:

- the batch norms use the batch's statistics and do not update their
  running ones (no compared number reads them), as every reference
  backbone here; eps 1e-5;
- the published initialisation zeroes each bottleneck's last BN and each
  non-local block's BN; the benchmark's weights give every BN scale 1
  (``run.make_weights``), so that each residual branch and each
  non-local block moves the compared steps;
- on a CUDA input with gradients on, each bottleneck and each non-local
  block is recomputed in the backward (``torch.utils.checkpoint``), so
  that the float32 query pass at batch 64 of 32 x 224^2 fits one card:
  batch norm in training mode recomputes the same statistics from the
  same batch, so the numbers do not change (the FLOP counts, on the
  ``meta`` device, run no recomputation).

Parameter names are the program's (``slow.stem.conv``,
``slow.s3_b1.conv1.conv``, ``slow.s3_b0.downsample.bn``,
``slow.nl_s3_b1.theta``, ``fast.s2_b0.conv2.bn``,
``fuse_s2.conv_f2s.bn``), so one state dict loads into both. ``quant``
rounds a bottleneck's residual sum, a non-local block's attention
products, its scaled attention and its sum, each concatenation and the
fast map's temporal mean, beside the rounding sites of ``Conv`` and
``BN``.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from benchmark.reference.models import BN, Conv, MaxPool, Quant

EPS = 1e-5
ALPHA = 8                  # fast / slow frame rate
BETA_INV = 8               # slow / fast channels
FUSION_RATIO = 2           # lateral output channels over fast channels
FUSION_KERNEL = 5
DEPTHS = (3, 4, 6, 3)
# the slow pathway's blocks followed by a non-local block, by stage
NONLOCAL = ((), (1, 3), (1, 3, 5), ())
# temporal kernel of the stem, and of every block of each stage
SLOW_TK = (1, (1, 1, 3, 3))
FAST_TK = (5, (3, 3, 3, 3))


def _ident(t):
    return t


def _recompute(fn, x):
    """fn(x), recomputed in the backward on a CUDA input that needs a
    gradient."""
    if x.is_cuda and torch.is_grad_enabled() and x.requires_grad:
        return checkpoint(fn, x, use_reentrant=False)
    return fn(x)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, pad=0, relu=True):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, pad)
        self.bn = BN(cout, EPS)
        self.relu = relu

    def forward(self, x):
        y = self.bn(self.conv(x))
        return torch.relu(y) if self.relu else y


class Bottleneck(nn.Module):
    def __init__(self, cin, inner, cout, tk, stride):
        super().__init__()
        self.conv1 = ConvBN(cin, inner, (tk, 1, 1), 1, (tk // 2, 0, 0))
        self.conv2 = ConvBN(inner, inner, (1, 3, 3), (1, stride, stride),
                            (0, 1, 1))
        self.conv3 = ConvBN(inner, cout, 1, relu=False)
        self.downsample = (ConvBN(cin, cout, 1, (1, stride, stride),
                                  relu=False)
                           if stride != 1 or cin != cout else None)
        self.quant: Quant = None

    def _forward(self, x):
        q = self.quant or _ident
        h = self.conv3(self.conv2(self.conv1(x)))
        res = x if self.downsample is None else self.downsample(x)
        return torch.relu(q(h + res))

    def forward(self, x):
        return _recompute(self._forward, x)


class NonLocal(nn.Module):
    """The ``dot_product`` non-local block on a [B, C, T, H, W] map."""

    def __init__(self, c):
        super().__init__()
        inner = c // 2
        self.theta = Conv(c, inner, 1, bias=True)
        self.phi = Conv(c, inner, 1, bias=True)
        self.g = Conv(c, inner, 1, bias=True)
        self.out = Conv(inner, c, 1, bias=True)
        self.bn = BN(c, EPS)
        self.pool = MaxPool((1, 2, 2), (1, 2, 2), 0)
        self.quant: Quant = None

    def _forward(self, x):
        q = self.quant or _ident
        theta = self.theta(x)
        pooled = self.pool(x)
        phi = self.phi(pooled).flatten(2)            # [B, inner, keys]
        g = self.g(pooled).flatten(2)
        att = q(torch.bmm(q(theta.flatten(2)).transpose(1, 2), q(phi)))
        att = q(att / phi.shape[2])                  # [B, queries, keys]
        y = q(torch.bmm(att, q(g).transpose(1, 2)))  # [B, queries, inner]
        y = y.transpose(1, 2).reshape(theta.shape)
        return q(x + self.bn(self.out(y)))

    def forward(self, x):
        return _recompute(self._forward, x)


class Pathway(nn.Module):
    """A stem and four stages; ``fuse_in`` the lateral channels each stage
    finds concatenated to its input."""

    def __init__(self, width, tk, fuse_in, depths, nonlocal_blocks):
        super().__init__()
        stem_tk, stage_tk = tk
        self.stem = ConvBN(3, width, (stem_tk, 7, 7), (1, 2, 2),
                           (stem_tk // 2, 3, 3))
        self.pool = MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1))
        self.stages = []
        cin = width + fuse_in[0]
        for s, depth in enumerate(depths):
            inner = width * 2 ** s
            names = []
            for i in range(depth):
                name = f"s{s + 2}_b{i}"
                setattr(self, name, Bottleneck(
                    cin, inner, 4 * inner, stage_tk[s],
                    2 if s > 0 and i == 0 else 1))
                cin = 4 * inner
                names.append(name)
                if i in nonlocal_blocks[s]:
                    setattr(self, "nl_" + name, NonLocal(cin))
                    names.append("nl_" + name)
            self.stages.append(names)
            if s + 1 < len(depths):
                cin += fuse_in[s + 1]

    def stem_out(self, x):
        return self.pool(self.stem(x))

    def stage(self, s, x):
        for name in self.stages[s]:
            x = getattr(self, name)(x)
        return x


class FuseFastToSlow(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.conv_f2s = ConvBN(c, FUSION_RATIO * c, (FUSION_KERNEL, 1, 1),
                               (ALPHA, 1, 1), (FUSION_KERNEL // 2, 0, 0))

    def forward(self, x):
        return self.conv_f2s(x)


class SlowFast(nn.Module):
    FUSES = ("fuse_stem", "fuse_s2", "fuse_s3", "fuse_s4")

    def __init__(self, depths=DEPTHS, nonlocal_blocks=NONLOCAL):
        super().__init__()
        fast_w = 64 // BETA_INV
        fast_out = (fast_w, 4 * fast_w, 8 * fast_w, 16 * fast_w)
        fuse_in = tuple(FUSION_RATIO * c for c in fast_out)
        self.slow = Pathway(64, SLOW_TK, fuse_in, depths, nonlocal_blocks)
        self.fast = Pathway(fast_w, FAST_TK, (0, 0, 0, 0), depths,
                            ((),) * len(depths))
        for name, c in zip(self.FUSES, fast_out):
            setattr(self, name, FuseFastToSlow(c))
        slow_out = 64 * 2 ** (len(depths) - 1) * 4
        self.feature_dim = slow_out + slow_out // BETA_INV
        self.quant: Quant = None

    def features(self, x):
        q = self.quant or _ident
        t = x.shape[2]
        idx = torch.linspace(0, t - 1, t // ALPHA,
                             dtype=torch.float64).long().to(x.device)
        slow = self.slow.stem_out(x.index_select(2, idx))
        fast = self.fast.stem_out(x)
        for s in range(4):
            lateral = getattr(self, self.FUSES[s])(fast)
            slow = self.slow.stage(s, q(torch.cat([slow, lateral], 1)))
            fast = self.fast.stage(s, fast)
        b, c, tf, h, w = fast.shape
        ts = slow.shape[2]
        fast = q(fast.reshape(b, c, ts, tf // ts, h, w).mean(3))
        return q(torch.cat([slow, fast], 1))


def build(depths=DEPTHS, nonlocal_blocks=NONLOCAL) -> nn.Module:
    """The published spec; a smaller ``depths`` (with ``nonlocal_blocks``
    inside it) is for the CPU tests only."""
    return SlowFast(tuple(depths), tuple(tuple(b) for b in nonlocal_blocks))
