"""Plain float32 S3D-G and 3-D ResNet-18 with the MoCo heads.

Written from the published architectures (Xie et al. 2018, S3D-G; Hara et
al. 2018, 3-D ResNet-18 with type-B shortcuts) and the RSPNet heads: a
global average pool, one linear layer and an L2 normalization for each of
the two pretext heads. Only ``torch.nn.functional`` operations: cuDNN's
convolutions, ``F.batch_norm`` and ``F.max_pool3d``; no kernel of the
program under test. Module and parameter names are the reference torch
models' (``encoder.feature.sepConv1.sep_conv.0.conv3d.weight``,
``encoder.layer1.0.conv1.weight``, ``fc1.linear.weight``), so that one
state dict loads into this model and into the program's.

Inputs are NDHWC clips [B, T, H, W, 3]; the backbones run in NCDHW.

``quant`` rounds a tensor where a lower-precision computation would hold
it: the input and the weight of every convolution and linear layer, and
every activation that a reduced-precision network keeps (each batch
norm's output, the self-gating's mean, gate and product, a residual sum,
the pooled features, the heads' outputs). The benchmark's control
computes in float8 through it; ``None`` computes in float32.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

Quant = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _t3(v):
    return (v, v, v) if isinstance(v, int) else tuple(v)


class Conv(nn.Module):
    """A bias-free (or biased) 3-D convolution whose weight is a leaf of
    its own (the reference names put it at ``<name>.weight``)."""

    def __init__(self, cin, cout, k, stride=1, pad=0, bias=False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, *_t3(k)))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None
        self.stride, self.pad = _t3(stride), _t3(pad)
        self.quant: Quant = None

    def forward(self, x):
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.conv3d(x, w, self.bias, self.stride, self.pad)


class Linear(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.quant: Quant = None

    def forward(self, x):
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x), self.quant(w)
        return F.linear(x, w, self.bias)


class BN(nn.Module):
    """Batch normalization over (N, T, H, W) with the biased variance of
    the batch, as every training-mode batch norm does. The running
    statistics are kept as buffers (for the state dict) but not updated:
    no compared number depends on them."""

    def __init__(self, c, eps):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))
        self.register_buffer("num_batches_tracked",
                             torch.zeros((), dtype=torch.long))

        self.quant: Quant = None

    def forward(self, x):
        y = F.batch_norm(x, None, None, self.weight, self.bias, True, 0.0,
                         self.eps)
        return y if self.quant is None else self.quant(y)


# --------------------------------------------------------------------------
# S3D-G
# --------------------------------------------------------------------------

S3DG_EPS = 1e-3


class BasicConv3d(nn.Module):
    """conv (no bias) -> BN -> ReLU."""

    def __init__(self, cin, cout, k, stride=1, pad=0):
        super().__init__()
        self.conv3d = Conv(cin, cout, k, stride, pad)
        self.bn = BN(cout, S3DG_EPS)

    def forward(self, x):
        return torch.relu(self.bn(self.conv3d(x)))


class SepConv3d(nn.Module):
    """(1,k,k) then (k,1,1) BasicConv3d, then the self-gating: a sigmoid of
    a 1^3 convolution (with bias) of the clip's spatio-temporal mean,
    multiplying every channel."""

    def __init__(self, cin, cout, k, stride=1, pad=0):
        super().__init__()
        self.sep_conv = nn.Sequential(
            BasicConv3d(cin, cout, (1, k, k), stride, (0, pad, pad)),
            BasicConv3d(cout, cout, (k, 1, 1), 1, (pad, 0, 0)))
        self.excitation = Conv(cout, cout, 1, bias=True)
        self.quant: Quant = None

    def forward(self, x):
        q = self.quant or (lambda t: t)
        x = self.sep_conv(x)
        gate = q(torch.sigmoid(self.excitation(q(x.mean(dim=(2, 3, 4),
                                                        keepdim=True)))))
        return q(gate * x)


class MaxPool(nn.Module):
    def __init__(self, k, s, p):
        super().__init__()
        self.k, self.s, self.p = _t3(k), _t3(s), _t3(p)

    def forward(self, x):
        return F.max_pool3d(x, self.k, self.s, self.p)


class Mixed(nn.Module):
    """Inception block: 1^3 | 1^3 -> sep 3 | 1^3 -> sep 3 | pool -> 1^3."""

    def __init__(self, cin, oc):
        super().__init__()
        self.branch0 = BasicConv3d(cin, oc[0], 1)
        self.branch1 = nn.Sequential(BasicConv3d(cin, oc[1], 1),
                                     SepConv3d(oc[1], oc[2], 3, 1, 1))
        self.branch2 = nn.Sequential(BasicConv3d(cin, oc[3], 1),
                                     SepConv3d(oc[3], oc[4], 3, 1, 1))
        self.branch3 = nn.Sequential(MaxPool(3, 1, 1),
                                     BasicConv3d(cin, oc[5], 1))

    def forward(self, x):
        return torch.cat([self.branch0(x), self.branch1(x), self.branch2(x),
                          self.branch3(x)], 1)


# Xie et al. 2018, table of the Inception-v1 widths: (name, widths, pool
# before the block as (kernel, stride, padding))
MIXED = [
    ("sepInc_3b", (64, 96, 128, 16, 32, 32), None),
    ("sepInc_3c", (128, 128, 192, 32, 96, 64), None),
    ("sepInc_4b", (192, 96, 208, 16, 48, 64), (3, 2, 1)),
    ("sepInc_4c", (160, 112, 224, 24, 64, 64), None),
    ("sepInc_4d", (128, 128, 256, 24, 64, 64), None),
    ("sepInc_4e", (112, 144, 288, 32, 64, 64), None),
    ("sepInc_4f", (256, 160, 320, 32, 128, 128), None),
    ("sepInc_5b", (256, 160, 320, 32, 128, 128), (2, 2, 0)),
    ("sepInc_5c", (384, 192, 384, 48, 128, 128), None),
]


class S3DG(nn.Module):
    feature_dim = 1024

    def __init__(self):
        super().__init__()
        layers = [("sepConv1", SepConv3d(3, 64, 7, 2, 3)),
                  ("maxPool1", MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1))),
                  ("basicConv3d", BasicConv3d(64, 64, 1)),
                  ("sep_conv2", SepConv3d(64, 192, 3, 1, 1)),
                  ("maxPool2", MaxPool((1, 3, 3), (1, 2, 2), (0, 1, 1)))]
        c = 192
        for name, oc, pool in MIXED:
            if pool is not None:
                layers.append((f"maxPool_{name}", MaxPool(*pool)))
            layers.append((name, Mixed(c, oc)))
            c = oc[0] + oc[2] + oc[4] + oc[5]
        self.feature = nn.Sequential()
        for name, mod in layers:
            self.feature.add_module(name, mod)

    def features(self, x):
        return self.feature(x)


# --------------------------------------------------------------------------
# 3-D ResNet-18
# --------------------------------------------------------------------------

RESNET_EPS = 1e-5


class BasicBlock(nn.Module):
    def __init__(self, cin, planes, stride):
        super().__init__()
        self.conv1 = Conv(cin, planes, 3, stride, 1)
        self.bn1 = BN(planes, RESNET_EPS)
        self.conv2 = Conv(planes, planes, 3, 1, 1)
        self.bn2 = BN(planes, RESNET_EPS)
        self.downsample = None
        if stride != 1 or cin != planes:
            self.downsample = nn.Sequential(Conv(cin, planes, 1, stride),
                                            BN(planes, RESNET_EPS))
        self.quant: Quant = None

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        short = x if self.downsample is None else self.downsample(x)
        out = out + short
        return torch.relu(out if self.quant is None else self.quant(out))


class ResNet3D(nn.Module):
    def __init__(self, layers: Sequence[int] = (2, 2, 2, 2)):
        super().__init__()
        self.feature_dim = 512
        self.conv1 = Conv(3, 64, 7, (1, 2, 2), 3)
        self.bn1 = BN(64, RESNET_EPS)
        cin = 64
        for i, (planes, n) in enumerate(zip((64, 128, 256, 512), layers)):
            blocks = []
            for j in range(n):
                blocks.append(BasicBlock(cin, planes,
                                         2 if i > 0 and j == 0 else 1))
                cin = planes
            setattr(self, f"layer{i + 1}", nn.Sequential(*blocks))

    def features(self, x):
        x = torch.relu(self.bn1(self.conv1(x)))
        x = F.max_pool3d(x, 3, 2, 1)
        for i in range(1, 5):
            x = getattr(self, f"layer{i}")(x)
        return x


# --------------------------------------------------------------------------
# the MoCo encoder: backbone and the two heads
# --------------------------------------------------------------------------

class Head(nn.Module):
    def __init__(self, cin, dim):
        super().__init__()
        self.linear = Linear(cin, dim)
        self.quant: Quant = None

    def forward(self, feat):
        q = self.quant or (lambda t: t)
        return q(F.normalize(q(self.linear(q(feat.mean(dim=(2, 3, 4))))),
                             dim=1))


class Encoder(nn.Module):
    """-> (A-VID embedding, RSP embedding), each [B, dim], unit rows."""

    def __init__(self, backbone: nn.Module, dim: int):
        super().__init__()
        self.encoder = backbone
        self.fc1 = Head(backbone.feature_dim, dim)
        self.fc2 = Head(backbone.feature_dim, dim)

    def forward(self, clips_ndhwc):
        feat = self.encoder.features(clips_ndhwc.permute(0, 4, 1, 2, 3))
        return self.fc1(feat), self.fc2(feat)

    def set_quant(self, quant: Quant) -> None:
        for m in self.modules():
            if hasattr(m, "quant"):
                m.quant = quant


BACKBONES = {"s3dg": S3DG, "resnet18": lambda: ResNet3D((2, 2, 2, 2))}


def build(arch: str, dim: int) -> Encoder:
    if arch not in BACKBONES:
        raise ValueError(f"the reference has no backbone {arch!r}")
    return Encoder(BACKBONES[arch](), dim)
